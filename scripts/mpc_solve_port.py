#!/usr/bin/env python3
"""MPC per-solve latency and batched-solve throughput of the port.

The port's counterpart of ``benchmarks/mpc_solve.py``: the 2D quadrotor
stabilization workload (``baseline.cfg_mpc_solve``), ``MPC(env,
horizon=H)`` with its defaults (3 AL x 6 inner iLQR iterations, the input
box as constraints), initial states 0.2 N(0, 1) from a seeded generator.
Prints the same two JSON lines: ``mpc_single_solve_ms`` (one problem a
solve, ``iters`` solves after two warm-ups) and
``mpc_batched_solves_per_sec`` (``iters`` batched solves of ``--batch``
problems after two warm-ups), with ``torch.cuda.synchronize`` as the
barrier, and the card's name and power limit as ``nvidia-smi`` gives them.

    python3 scripts/mpc_solve_port.py [--batch 1024] [--horizon 20] [--device cpu]

Runs on the card unless ``--device cpu`` is given (a rehearsal: its lines
say ``"device": "cpu"`` and carry no card).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0]


def workload(batch, horizon, device, seed=0):
    """(mpc, x0s): the controller and ``batch`` initial states on ``device``."""
    import torch

    from safe_control_gym_torch.baseline import cfg_mpc_solve
    from safe_control_gym_torch.controllers.mpc import MPC
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor

    env = make_quadrotor(cfg_mpc_solve(), device=device)
    mpc = MPC(env, horizon=horizon)
    gen = torch.Generator().manual_seed(seed)
    x0s = (0.2 * torch.randn(batch, env.symbolic.nx, generator=gen)).to(device)
    return mpc, x0s


def main(batch=1024, horizon=20, iters=8, device=None):
    import torch

    from safe_control_gym_torch.utils.device import resolve_device

    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mpc, x0s = workload(batch, horizon, dev)
    where = ({"device": torch.cuda.get_device_name(0), "card": card_line()}
             if dev.type == "cuda" else {"device": "cpu", "card": None})

    def single(i):
        return mpc.solve_batch(x0s[i % batch][None])[0]

    for i in range(2):
        single(i)
    sync()
    t0 = time.perf_counter()
    for i in range(iters):
        single(i)
    sync()
    single_ms = (time.perf_counter() - t0) / iters * 1e3
    print(json.dumps({"metric": "mpc_single_solve_ms", "value": single_ms, "unit": "ms/solve",
                      "horizon": horizon, **where}), flush=True)

    for _ in range(2):
        mpc.solve_batch(x0s)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        mpc.solve_batch(x0s)
    sync()
    dt = time.perf_counter() - t0
    print(json.dumps({"metric": "mpc_batched_solves_per_sec", "value": iters * batch / dt,
                      "unit": "solves/s", "batch": batch, "horizon": horizon,
                      "ms_per_batched_solve": dt / iters * 1e3, **where}), flush=True)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--horizon", type=int, default=20)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--device", default=None, help="cpu for a rehearsal; the card by default")
    a = p.parse_args()
    main(a.batch, a.horizon, a.iters, a.device)
