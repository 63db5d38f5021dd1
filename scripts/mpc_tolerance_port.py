#!/usr/bin/env python3
"""The readings behind ``chip_smoke.py``'s limits on a card solve against
the CPU's (MPC_COST_RTOL, MPC_US_REL, GP_COST_RTOL, GP_US_REL).

Three paths, as ``chip_smoke.py`` drives them, each from ``--seeds`` seeds:

- ``mpc_solve``: ``phase_mpc_solve``'s batched solve of the 2D quad
  (``--batch`` problems, initial states 0.2 N(0, 1) from the seed), its
  first MPC_CPU_ENVS problems;
- ``mpc_quad3d``: the first MPC_CPU_STEPS solves of ``phase_mpc``'s 3D
  closed loop (``--batch`` envs reset from the seed), MPC_CPU_B envs each;
- ``gp_mpc``: ``phase_gp_mpc``'s ``learn()`` (the controller's seed) and
  its GP_STEPS closed-loop solves of GP_B envs (initial states from the
  seed).

Each card solve is redone on the CPU from the same inputs by the same
controller (``sound``) and by controllers with one fault planted
(``controls``): one inner iLQR iteration fewer in each AL iteration, the
input box left out (MPC), the GP mean left out, the probabilistic margins
left out (GP-MPC).  A reading is ``chip_smoke.solve_errs``'s pair: the
costs' largest relative error and the inputs' largest error over their
largest.  Prints one JSON line a seed and path, then a summary line: for
each path and reading, the largest sound value and each control's
smallest, and the card's name and power limit as ``nvidia-smi`` gives them.

    python3 scripts/mpc_tolerance_port.py [--seeds 5] [--batch 1024] [--device cpu]

Runs on the card unless ``--device cpu`` is given (a rehearsal: both sides
on the CPU, every sound reading 0).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def mpc_solve_path(dev, seed, batch):
    import torch

    from chip_smoke import MPC_CPU_ENVS, MPC_H, solve_errs
    from safe_control_gym_torch.baseline import cfg_mpc_solve
    from safe_control_gym_torch.controllers.mpc import MPC
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor

    mpc = MPC(make_quadrotor(cfg_mpc_solve(), device=dev), horizon=MPC_H)
    x0s = 0.2 * torch.randn(batch, mpc.model.nx, generator=torch.Generator().manual_seed(seed))
    us, cost = mpc.solve_batch(x0s.to(dev))
    ctrls = {"sound": MPC(make_quadrotor(cfg_mpc_solve(), device="cpu"), horizon=MPC_H),
             "inner_iteration_fewer": MPC(make_quadrotor(cfg_mpc_solve(), device="cpu"),
                                          horizon=MPC_H, inner_iters=5),
             "input_box_left_out": MPC(make_quadrotor(cfg_mpc_solve(constraints=None),
                                                      device="cpu"), horizon=MPC_H)}
    return {k: solve_errs(us, cost, *c.solve_batch(x0s[:MPC_CPU_ENVS])) for k, c in ctrls.items()}


def mpc_quad3d_path(dev, seed, batch):
    from chip_smoke import MPC_CPU_B, MPC_CPU_STEPS, MPC_QUAD3D, MPC_QUAD3D_KW, mpc_loop, redo_solves
    from safe_control_gym_torch.controllers.mpc import MPC
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor
    from safe_control_gym_torch.ops import ctr_prng

    env = make_quadrotor(QuadrotorConfig(**MPC_QUAD3D), device=dev)
    mpc = MPC(env, **MPC_QUAD3D_KW)
    _, solves = mpc_loop(mpc, env, MPC_CPU_STEPS, ctr_prng.env_seeds_from_seed(seed, batch, dev),
                         record=MPC_CPU_STEPS)

    def cpu(constraints=MPC_QUAD3D["constraints"], **kw):
        c = MPC(make_quadrotor(QuadrotorConfig(**dict(MPC_QUAD3D, constraints=constraints)),
                               device="cpu"), **dict(MPC_QUAD3D_KW, **kw))
        c.P_term = mpc.P_term.cpu()
        return c

    ctrls = {"sound": cpu(), "inner_iteration_fewer": cpu(inner_iters=2),
             "input_box_left_out": cpu(constraints=None)}
    n = min(MPC_CPU_B, batch)
    return {k: redo_solves(c, solves, n) for k, c in ctrls.items()}


def gp_mpc_path(dev, seed):
    import torch

    from chip_smoke import GP_B, GP_KW, GP_QUAD2D, gp_cpu_copy, gp_loop, redo_solves
    from safe_control_gym_torch.controllers.gp_mpc import GPMPC
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor

    env = make_quadrotor(QuadrotorConfig(**GP_QUAD2D), device=dev)
    gp = GPMPC(env, seed=seed, **GP_KW)
    gp.learn()
    _, solves = gp_loop(gp, env, seed)
    no_mean = gp.gp_state._replace(alpha=torch.zeros_like(gp.gp_state.alpha))
    no_margins = gp_cpu_copy(gp)
    margins = no_margins._build_margins_fn()
    no_margins._build_margins_fn = lambda: (lambda x0, us: torch.zeros_like(margins(x0, us)))
    no_margins._solve = no_margins._make_gp_solver()
    ctrls = {"sound": gp_cpu_copy(gp), "gp_mean_left_out": gp_cpu_copy(gp, no_mean),
             "margins_left_out": no_margins}
    return {k: redo_solves(c, solves, GP_B) for k, c in ctrls.items()}


def main(seeds=5, batch=1024, device=None):
    from chip_smoke import card_line
    from safe_control_gym_torch.utils.device import resolve_device

    dev = resolve_device(device)
    paths = {"mpc_solve": lambda s: mpc_solve_path(dev, s, batch),
             "mpc_quad3d": lambda s: mpc_quad3d_path(dev, s, batch),
             "gp_mpc": lambda s: gp_mpc_path(dev, s)}
    summary = {}
    for name, path in paths.items():
        rows = []
        for seed in range(seeds):
            errs = path(seed)
            rows.append(errs)
            print(json.dumps({"path": name, "seed": seed, "device": dev.type,
                              **{k: {"cost_rel": c, "us_rel": u} for k, (c, u) in errs.items()}}),
                  flush=True)
        summary[name] = {
            reading: {"sound_max": max(r["sound"][i] for r in rows),
                      **{f"{k}_min": min(r[k][i] for r in rows) for k in rows[0] if k != "sound"}}
            for i, reading in enumerate(("cost_rel", "us_rel"))}
    card = card_line() if dev.type == "cuda" else None
    print(json.dumps({"summary": summary, "seeds": seeds, "batch": batch, "card": card}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--device", default=None, help="cpu for a rehearsal (default: the card)")
    args = ap.parse_args()
    main(args.seeds, args.batch, args.device)
