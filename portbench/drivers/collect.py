"""Collect traffic: calls of the policy kernel back to back, no update.

Set-up builds the program's whole-rollout policy engine of the
configuration's family (``FastPolicyRollout``: K3; the cart-pole's: K6),
packs the weights made from the seed with the program's ``pack_weights``,
resets the envs from the seed and runs the first call (it warms up the
call's one shape).  Each unit is one ``run`` of T steps of B envs on the
previous call's rows, keyed by the next of the call seeds drawn on the
device from the seed.  The first call and ``sampled_calls`` calls drawn
from the seed among calls 1 to ``sample_range`` are kept and checked after
the window (:func:`portbench.reference.check.record_gap`, from the
program's own rows at each call's start; the first call's rows against the
reference's reset).  A traced run makes ``trace_units`` calls after the
first, so ``sample_range`` may not exceed it; a sampled call that a run
never made counts in ``sampled_calls_missing``, whose limit is 0.

Traffic keys: ``num_envs``, ``rollout_steps``, ``sampled_calls``,
``sample_range``, ``trace_units``.
"""

from __future__ import annotations

import gc

import torch

from portbench.drivers import common
from portbench.reference import check, envs, rng

MAX_CALLS = 1 << 16  # call seeds drawn at set-up; a window makes far fewer calls


class Job:
    def __init__(self, cell, seed: int, device):
        from safe_control_gym_torch.controllers.ppo import ActorCritic, fast_rollout_engine
        from safe_control_gym_torch.parallel.fast_policy import pack_weights

        cfg, tr = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        self.B, self.T = int(tr["num_envs"]), int(tr["rollout_steps"])
        if int(tr["sample_range"]) > int(tr["trace_units"]):
            raise ValueError(f"{cell.name}: sample_range {tr['sample_range']} exceeds the "
                             f"{tr['trace_units']} calls of a traced run")
        h, act = int(cfg["ppo"]["hidden_dim"]), cfg["ppo"]["activation"]
        env = common.build_env(cfg, device)
        engine, ok = fast_rollout_engine(env.config)
        if not ok:
            raise ValueError(f"{cell.name}: the config is outside {engine.__name__}'s envelope")
        self.fp = engine(env, self.B, self.T, mlp_hidden=h, mlp_act=act, device=device)
        nx, nu = env.spaces.obs_dim, env.spaces.action_dim
        self.w0 = common.make_weights(seed, nx, nu, h, device)
        ac = ActorCritic(nx, nu, h, act).to(device)
        common.load_weights(ac, self.w0)
        self.packed = pack_weights(ac.actor, ac.critic, ac.logstd)
        gen = torch.Generator(device=device).manual_seed(seed & (2**63 - 1))
        self.seeds = torch.randint(0, 2**31 - 1, (MAX_CALLS,), generator=gen, device=device,
                                   dtype=torch.int32)
        pick = torch.Generator().manual_seed(seed & (2**63 - 1))
        self.sample = {0} | {1 + int(i) for i in torch.randperm(
            int(tr["sample_range"]), generator=pick)[:int(tr["sampled_calls"])]}
        self.rows = self.fp.reset(seed)
        self.kept = {}
        self.calls = 0
        self.unit()
        self.unit_env_steps = self.B * self.T

    def unit(self):
        k = self.calls
        rows_in = self.rows
        self.rows, traj = self.fp.run(rows_in, self.packed, seed=self.seeds[k:k + 1])
        if k in self.sample:
            self.kept[k] = (rows_in, traj, self.rows)
        self.calls += 1

    def end_to_end(self, wall: float, units: int, unit_ms):
        return {"collect_env_steps_per_s": units * self.unit_env_steps / wall}

    def free(self):
        del self.fp, self.rows
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        cfg = self.cell.config
        p = envs.params(cfg["family"], cfg["env"])
        layout = cfg["program"]["rows"]
        es = rng.env_seeds(self.seed, self.B, self.device)
        gap = check.start_gap(p, es, self.kept[0][0], layout)
        self.ties = 0  # done flags a rounding tie decides, left uncompared
        for k, (rows_in, traj, rows_out) in sorted(self.kept.items()):
            g, n = check.record_gap(p, cfg["ppo"]["activation"], self.w0, self.seeds[k], es,
                                    rows_in, traj, rows_out, layout)
            gap, self.ties = max(gap, g), self.ties + n
        return {"record_gap": gap, "sampled_calls_missing": len(self.sample - set(self.kept))}
