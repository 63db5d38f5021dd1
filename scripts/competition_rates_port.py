"""Competition robustness sweep of the port: completion rates across spawn seeds.

The port's counterpart of ``benchmarks/competition_rates.py``: the same
arguments and the same JSON layout, with every episode flown through the
port's full firmware-in-the-loop stack (``safe_control_gym_torch.
competition.getting_started.run``: the fused 500 Hz firmware block with K1
once a tick, the MPCC or spline racing stage) on the card by default.  A
seed's crash is a data point, not a sweep abort (its row carries the error
and its traceback goes to stderr).  The artifact adds the card (name and
power limit from ``nvidia-smi``) and the device.

``--first-seed`` (default 0) starts each cell's seeds there, so that a
sweep can take seeds k..k+N-1.

Usage (on the card):
    python3 scripts/competition_rates_port.py --levels 2 --spline-levels "" \\
        --first-seed 1 --seeds 2 --out results/rates.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = os.path.join(ROOT, "safe_control_gym_tpu", "competition", "levels")


def sweep(level: int, use_mpcc: bool, seeds, episode_len=None, verbose=False, device=None):
    import yaml

    from safe_control_gym_torch.competition.getting_started import run

    with open(os.path.join(LEVELS, f"level{level}.yaml")) as f:
        base = yaml.safe_load(f)["quadrotor_config"]
    if episode_len:
        base["episode_len_sec"] = episode_len
    n_gates = len(base.get("gates") or [])
    rows = []
    for s in seeds:
        cfg = dict(base)
        cfg["seed"] = int(s)
        t0 = time.time()
        try:
            stats = run(cfg, num_episodes=1, use_firmware=True, use_mpcc=use_mpcc,
                        verbose=False, device=device)[0]
        except Exception as e:  # a crash is a data point, not a sweep abort
            traceback.print_exc()
            stats = {"error": f"{type(e).__name__}: {e}", "gates_passed": 0,
                     "collisions": -1, "reward": float("nan")}
        stats["seed"] = int(s)
        stats["wall_s"] = round(time.time() - t0, 1)
        rows.append(stats)
        if verbose:
            print(f"level{level} mpcc={use_mpcc} seed={s}: gates={stats.get('gates_passed')} "
                  f"collisions={stats.get('collisions')} ({stats['wall_s']}s)", flush=True)
    ok = [r for r in rows if "error" not in r]
    complete = [r for r in ok if r.get("gates_passed", 0) >= n_gates]
    return {
        "level": level,
        "use_mpcc": use_mpcc,
        "n_gates": n_gates,
        "n_seeds": len(seeds),
        "completion_rate": round(len(complete) / max(len(seeds), 1), 3),
        "mean_gates": round(sum(r.get("gates_passed", 0) for r in rows) / max(len(rows), 1), 2),
        "collision_rate": round(sum(1 for r in ok if r.get("collisions", 0) > 0)
                                / max(len(seeds), 1), 3),
        "errors": sum(1 for r in rows if "error" in r),
        "per_seed": rows,
    }


def card_line(device):
    """The card's name and power limit, as nvidia-smi gives them."""
    if device.type != "cuda":
        return None
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8,
                    help="seeds first..first+N-1 per (level, path) cell")
    ap.add_argument("--first-seed", type=int, default=0, help="the first seed of every cell")
    ap.add_argument("--levels", default="0,2,3")
    ap.add_argument("--spline-levels", default="2",
                    help="levels to ALSO sweep with the spline path (use_mpcc=False) for "
                         "comparison")
    ap.add_argument("--episode-len", type=float, default=None)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()

    sys.path.insert(0, ROOT)
    from safe_control_gym_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    seeds = list(range(args.first_seed, args.first_seed + args.seeds))
    cells = [(int(x), True) for x in args.levels.split(",") if x != ""]
    cells += [(int(x), False) for x in args.spline_levels.split(",") if x != ""]
    results = [sweep(lv, mpcc, seeds, episode_len=args.episode_len, verbose=args.verbose,
                     device=device) for lv, mpcc in cells]
    artifact = {
        "metric": "competition_completion_rates",
        "seeds_per_cell": args.seeds,
        "first_seed": args.first_seed,
        "device": str(device),
        "card": card_line(device),
        "note": ("full firmware-in-the-loop episodes of the port (fused 500 Hz block, K1 once "
                 "a tick; run() default) on the named device; completion = all gates passed "
                 "in one episode; per-seed rows carry 500 Hz min gate/obstacle clearances"),
        "cells": results,
    }
    line = json.dumps(artifact)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
