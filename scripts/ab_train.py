#!/usr/bin/env python3
"""Time the PPO train step of two source trees on one card, in turns.

Each run is a process of its own that imports ``safe_control_gym_torch``
from one tree (this one, or another, for example the parent commit
unpacked with ``git archive <commit>`` into a directory) and drives the
``rl_train`` shapes of ``chip_smoke.py`` (B = 4096, T = 128, 10 epochs of 4
minibatches of 131072, hidden 64, normalized action space) on config 4,
CartPole stabilization and quad-2D stabilization, and config 4 at hidden
width 128 (``config4_h128``): two warm-up train steps,
then ``--steps`` timed ones (host clock, ending in a synchronize), and one
profiled step (device busy time and kernel launches).  The runs go other,
this, this, other; the medians and their ratios are printed with the card
as ``nvidia-smi`` names it.  ``--families`` runs only the families named.

    python3 scripts/ab_train.py --other DIR [--steps 5] [--families cartpole,quad2d]
        [--out results.json]

Needs one CUDA card and ``nvcc``; each tree builds its own kernels.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("config4", "cartpole", "quad2d", "config4_h128")


def smoke():
    """This tree's chip_smoke.py as a module; its functions import the
    package lazily, so they take whichever tree leads ``sys.path``."""
    spec = importlib.util.spec_from_file_location("smoke_here", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str, steps: int, families=FAMILIES) -> dict:
    sys.path.insert(0, tree)
    import torch

    from safe_control_gym_torch import kernels
    from safe_control_gym_torch.controllers.ppo import PPO
    from safe_control_gym_torch.envs.cartpole import make_cartpole
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor

    assert kernels.__file__.startswith(os.path.abspath(tree)), kernels.__file__
    S = smoke()
    dev = torch.device("cuda")
    envs = {"config4": lambda: make_quadrotor(S.cfg4(normalized_rl_action_space=True), device=dev),
            "cartpole": lambda: make_cartpole(S.cfg_cartpole_rl(), device=dev),
            "quad2d": lambda: make_quadrotor(S.cfg_quad2d_rl(), device=dev)}
    envs["config4_h128"] = envs["config4"]
    out = {}
    for fam in families:
        ppo = PPO(envs[fam](), seed=0, rollout_batch_size=S.TRAIN_B, rollout_steps=S.TRAIN_T,
                  opt_epochs=S.EPOCHS, mini_batch_size=S.MB,
                  hidden_dim=128 if fam == "config4_h128" else S.HIDDEN,
                  use_fast_rollout=True, reshuffle_each_epoch=False)
        assert ppo._fp is not None and ppo._fu is not None
        for _ in range(2):
            ppo.state, _ = ppo._train_step(ppo.state)
        torch.cuda.synchronize()
        walls = []
        for _ in range(steps):
            t0 = time.perf_counter()
            ppo.state, _ = ppo._train_step(ppo.state)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        _, kern = S.profile_kernels(lambda: ppo._train_step(ppo.state), 1)
        out[fam] = {"wall_ms": walls, "device_ms": sum(t for t, _ in kern.values()),
                    "kernel_launches": sum(n for _, n in kern.values())}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of the other tree")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--families", default=",".join(FAMILIES),
                    help=f"comma-separated, of {', '.join(FAMILIES)}")
    ap.add_argument("--out", help="also write the results here as JSON")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_train: CUDA is not available", file=sys.stderr)
        return 2
    families = args.families.split(",")
    if not set(families) <= set(FAMILIES):
        ap.error(f"--families takes {FAMILIES}")
    if args.worker:
        print(json.dumps(worker(args.worker, args.steps, families)))
        return 0
    if not args.other:
        ap.error("--other is required")
    trees = {"other": os.path.abspath(args.other), "this": ROOT}
    runs = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", trees[name],
                              "--steps", str(args.steps), "--families", args.families],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"ab_train worker on {name} failed:\n{res.stdout}{res.stderr}")
        runs[name].append(json.loads(next(line for line in res.stdout.splitlines()
                                          if line.startswith("{"))))
    summary = {}
    for fam in families:
        med = {k: statistics.median(w for r in rs for w in r[fam]["wall_ms"]) for k, rs in runs.items()}
        dev_ms = {k: statistics.median(r[fam]["device_ms"] for r in rs) for k, rs in runs.items()}
        summary[fam] = {"median_wall_ms": med, "device_ms": dev_ms,
                        "wall_this_over_other": med["this"] / med["other"],
                        "launches": {k: rs[0][fam]["kernel_launches"] for k, rs in runs.items()}}
    card = smoke().card_line()
    print(card)
    for fam, s in summary.items():
        print(f"{fam}: train step wall median {s['median_wall_ms']['other']:.3f} ms (other) vs "
              f"{s['median_wall_ms']['this']:.3f} ms (this), ratio {s['wall_this_over_other']:.4f}; "
              f"device busy {s['device_ms']['other']:.3f} vs {s['device_ms']['this']:.3f} ms; "
              f"launches {s['launches']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "steps": args.steps, "runs": runs, "summary": summary}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"total {time.perf_counter() - t0:.1f} s")
    sys.exit(rc)
