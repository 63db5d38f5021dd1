#!/usr/bin/env python3
"""Weak scaling over multi-process clusters: the counterpart of
``benchmarks/scaling_multihost.py`` (:57-361), without its TPU dispatch
probe and pod projection, which describe TPU hardware.

Constant envs a host, growing host count: each row is a real cluster of
``hosts x devices_per_host`` ranks (``distributed.launch_workers``, gloo),
each rank resetting and stepping its own envs and the episode statistics
summed across the ranks each call.  The worker (``_multihost_worker.perf``)
times the sharded rollout at two lengths, ``t(S) = a + b S``, and the
rollout grows until the fixed cost ``a`` is under ``--max-coord-frac`` of
the timed wall.  Each row is the median of ``--trials`` clusters:

- ``efficiency_wall``: env-steps/s(N) / (N x env-steps/s(1));
- ``efficiency_slope``: b(1) / b(N), the per-step compute alone.

All ranks run on this one machine: on the card they share its one GPU
(``device=cuda``: gloo ranks on ``cuda:0``, whose kernels the card
time-slices between the processes) and the host's cores; on the CPU they
share the cores.  The output says which, so its efficiencies measure that
sharing, not independent hosts.  Prints one JSON line a row and a summary
line; writes the artifact only under ``--out``.

    python3 scripts/scaling_multihost_port.py [--max-hosts 4]
        [--devices-per-host 1] [--envs-per-host 1024] [--steps 64]
        [--trials 3] [--device cpu] [--out results/scaling_multihost_port.json]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = "safe_control_gym_torch.parallel._multihost_worker"


def measure(n_hosts, devices_per_host, envs_per_host, s_short, s_long, iters, device):
    from safe_control_gym_torch.parallel import distributed

    return distributed.result_line(distributed.launch_workers(
        WORKER, n_hosts, devices_per_host, device=device, timeout=900.0,
        env_overrides={"SCG_TEST_MODE": "perf",
                       "SCG_TEST_NUM_ENVS": str(envs_per_host * n_hosts),
                       "SCG_TEST_STEPS_SHORT": str(s_short), "SCG_TEST_STEPS_LONG": str(s_long),
                       "SCG_TEST_ITERS": str(iters)}), "MULTIHOST_PERF ")


def measure_compute_dominated(n, devices_per_host, envs_per_host, steps, iters, device,
                              max_coord_frac, max_steps=4096):
    """Grow the rollout until the fixed cost is under ``max_coord_frac``."""
    s_short, s_long = steps, 4 * steps
    while True:
        r = measure(n, devices_per_host, envs_per_host, s_short, s_long, iters, device)
        if r["coordination_fraction"] <= max_coord_frac or s_long >= max_steps:
            return {**r, "compute_dominated": r["coordination_fraction"] <= max_coord_frac}
        s_short, s_long = s_long, min(4 * s_long, max_steps)


def main(max_hosts=4, devices_per_host=1, envs_per_host=1024, steps=64, iters=4, trials=3,
         max_coord_frac=0.5, device=None, out=None):
    from safe_control_gym_torch.utils.device import card_line, resolve_device

    dev = resolve_device(device)
    shares = (f"every rank runs on this machine and shares its {os.cpu_count()} CPU cores"
              + (f" and the one card ({card_line(dev)}), through gloo ranks on cuda:0"
                 if dev.type == "cuda" else ""))
    rows, base, n = [], None, 1
    while n <= max_hosts:
        runs = [measure_compute_dominated(n, devices_per_host, envs_per_host, steps, iters,
                                          dev.type, max_coord_frac) for _ in range(trials)]
        r = dict(runs[0])
        for k in ("steps_per_sec", "per_step_us", "per_call_overhead_ms",
                  "coordination_fraction"):
            r[k] = statistics.median(x[k] for x in runs)
            r[f"{k}_trials"] = [x[k] for x in runs]
        base = base or r
        r["efficiency_wall"] = r["steps_per_sec"] / (base["steps_per_sec"] * n)
        r["efficiency_slope"] = base["per_step_us"] / r["per_step_us"]
        rows.append({"hosts": n, "devices_per_host": devices_per_host, **r})
        print(json.dumps(rows[-1]), flush=True)
        n *= 2
    worst = min(rows[1:] or rows, key=lambda x: x["efficiency_wall"])
    summary = {"metric": "multihost_scaling_efficiency", "value": worst["efficiency_wall"],
               "value_is": "the worst efficiency_wall over the rows of 2 or more hosts",
               "hosts": worst["hosts"], "efficiency_slope": worst["efficiency_slope"],
               "card": card_line(dev), "shares": shares}
    print(json.dumps(summary), flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({**summary, "rows": rows}, f, indent=1)
    return {**summary, "rows": rows}


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--max-hosts", type=int, default=4)
    p.add_argument("--devices-per-host", type=int, default=1)
    p.add_argument("--envs-per-host", type=int, default=1024)
    p.add_argument("--steps", type=int, default=64, help="the short length; the long is 4x")
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--max-coord-frac", type=float, default=0.5)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default=None)
    a = p.parse_args()
    main(a.max_hosts, a.devices_per_host, a.envs_per_host, a.steps, a.iters, a.trials,
         a.max_coord_frac, a.device, a.out)
