"""Collect traffic on a program whose rows hold only some of a reset's
inertial draws (the planar quadrotors': mass and Iyy of four).

The collect driver's ``Job`` (:mod:`portbench.drivers.collect`: set-up,
units, the sampled calls, ``end_to_end``, ``free``), whose check takes the
start gap of :mod:`portbench.reference.held_rows` in place of
:func:`portbench.reference.check.start_gap`; the record gap of every kept
call is the same.

Traffic keys: those of ``collect``.
"""

from __future__ import annotations

from portbench.drivers import collect
from portbench.reference import check, envs, held_rows, rng


class Job(collect.Job):
    def check(self):
        cfg = self.cell.config
        p = envs.params(cfg["family"], cfg["env"])
        layout = cfg["program"]["rows"]
        es = rng.env_seeds(self.seed, self.B, self.device)
        gap = held_rows.start_gap(p, es, self.kept[0][0], layout)
        self.ties = 0  # done flags a rounding tie decides, left uncompared
        for k, (rows_in, traj, rows_out) in sorted(self.kept.items()):
            g, n = check.record_gap(p, cfg["ppo"]["activation"], self.w0, self.seeds[k], es,
                                    rows_in, traj, rows_out, layout)
            gap, self.ties = max(gap, g), self.ties + n
        return {"record_gap": gap, "sampled_calls_missing": len(self.sample - set(self.kept))}
