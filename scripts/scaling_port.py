#!/usr/bin/env python3
"""Device-count scaling of the sharded rollout: the counterpart of
``benchmarks/scaling.py``.

One row per device count available: 1, 2, 4, ... up to the CUDA device
count (the CPU counts as one device).  A row runs the general engine's
sharded rollout (``_multihost_worker.perf``: 3D stabilization under hover,
K1 once a step on the card) at ``envs_per_device x n`` envs, timed at two
lengths and fit to ``t(S) = a + b S``: one device in this process, with no
process group; n >= 2 as an NCCL cluster of n ranks, one a card
(``distributed.launch_workers``).  ``scaling_efficiency`` is the row's
env-steps/s over n times the one-device row's.  On a one-card machine there
is one row, and the output says so.  Prints one JSON line a row and a
summary line; writes the rows only under ``--out``.

    python3 scripts/scaling_port.py [--envs-per-device 1024] [--steps 64]
        [--device cpu] [--out results/scaling_port.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = "safe_control_gym_torch.parallel._multihost_worker"


def main(envs_per_device=1024, steps=64, iters=4, device=None, out=None):
    import torch

    from safe_control_gym_torch.parallel import _multihost_worker as MW
    from safe_control_gym_torch.parallel import distributed
    from safe_control_gym_torch.utils.device import card_line, resolve_device

    dev = resolve_device(device)
    n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    rows, base, n = [], None, 1
    while n <= n_devices:
        B = n * envs_per_device
        if n == 1:
            r = MW.perf(B, steps, 4 * steps, iters, dev, distributed.host_mesh())
        else:
            r = distributed.result_line(distributed.launch_workers(
                WORKER, 1, n, device=dev.type, timeout=900.0,
                env_overrides={"SCG_TEST_MODE": "perf", "SCG_TEST_NUM_ENVS": str(B),
                               "SCG_TEST_STEPS_SHORT": str(steps),
                               "SCG_TEST_STEPS_LONG": str(4 * steps),
                               "SCG_TEST_ITERS": str(iters)}), "MULTIHOST_PERF ")
        base = base or r["steps_per_sec"]
        rows.append({"devices": n, **r, "scaling_efficiency": r["steps_per_sec"] / (base * n)})
        print(json.dumps(rows[-1]), flush=True)
        n *= 2
    summary = {"metric": "scaling_efficiency", "n_rows": len(rows),
               "value": rows[-1]["scaling_efficiency"], "device_count": n_devices,
               "card": card_line(dev),
               "note": (f"{n_devices} {dev.type} device(s) available: one row per power of two "
                        "up to that count" + ("; one row, so no scaling is measured"
                                              if len(rows) == 1 else ""))}
    print(json.dumps(summary), flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({**summary, "rows": rows}, f, indent=1)
    return {**summary, "rows": rows}


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--envs-per-device", type=int, default=1024)
    p.add_argument("--steps", type=int, default=64, help="the short length; the long is 4x")
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default=None)
    a = p.parse_args()
    main(a.envs_per_device, a.steps, a.iters, a.device, a.out)
