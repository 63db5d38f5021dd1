"""The start check of a program whose rows hold some of a reset's inertial
draws.

:func:`portbench.reference.check.start_gap` compares every inertial draw
with a row of the program's layout.  The planar quadrotors draw four
(mass, Ixx, Iyy, Izz) and their rows hold two: a configuration names the
rows it holds (``rows.inertial``) and the draw each holds
(``rows.inertial_draws``), and each held draw is compared with its row
alone.  A draw that no row holds is compared nowhere at the start; what
the dynamics read of the inertia is compared at every step by
:func:`portbench.reference.check.record_gap`.
"""

from __future__ import annotations

import torch

from portbench.reference import check, envs, rng


def held_draws(layout) -> list:
    """The draws the rows ``layout['inertial']`` hold; raises where a row or
    a draw is named twice, or where the two lists differ in length."""
    rows, draws = list(layout["inertial"]), list(layout["inertial_draws"])
    if len(rows) != len(draws) or len(set(rows)) != len(rows) or len(set(draws)) != len(draws):
        raise ValueError(f"rows {rows} and draws {draws} must pair one to one")
    return draws


@torch.no_grad()
def start_gap(p, env_seed, rows, layout):
    """The program's reset rows against the reference's episode-0 draws:
    state, the held inertial draws, step and episode counters, and the
    seed's bits.  The inertia is small in SI units (Iyy 1.4e-5 kg m^2), so
    its gap is taken relative to the draw itself."""
    ep0 = torch.zeros_like(env_seed)
    s, inert = envs.episode_draws(p, env_seed, ep0)
    held = torch.stack([inert[k] for k in held_draws(layout)])
    gaps = [check._gap(rows[:p["nx"]], torch.stack(s)),
            float(((rows[layout["inertial"]] - held).abs() / held.abs()).max()),
            check._gap(rows[layout["step"]], torch.zeros_like(rows[0])),
            check._gap(rows[layout["episode"]], torch.zeros_like(rows[0]))]
    bits = rows[layout["seed"]].contiguous().view(torch.int32).to(torch.int64) & rng.U32
    return max(gaps + [float((bits != env_seed).any())])
