#!/usr/bin/env python3
"""Learner throughput: whole PPO train steps, the counterpart of
``benchmarks/rl_throughput.py``.

Times the complete train step on config 4's figure-8 task with the
normalized action space (``baseline.cfg_rl_figure8``): the collection (the
general engine, K1 once a step, or with ``--fast`` K3 in one launch), GAE,
and 10 epochs of 4 minibatch steps (K4 on the card).  Two warm-up steps, then ``iters`` timed steps
ended by ``torch.cuda.synchronize()``.  Prints one JSON line with
``ppo_train_env_steps_per_sec``, the launches a train step, and the card's
name and power limit; writes it only under ``--out``.

    python3 scripts/rl_throughput_port.py [--batch 1024] [--steps 64] [--fast]
        [--once-per-step-shuffle] [--device cpu] [--out results/rl_throughput.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch_counts():
    from safe_control_gym_torch.ops import quad_substeps
    from safe_control_gym_torch.parallel import fast_policy, fast_update

    return {"k1": quad_substeps.quad3d_substeps.launches,
            "k3": fast_policy.policy_rollout.launches, "k4": fast_update.ppo_grads.launches}


def main(batch=1024, steps=64, iters=4, fast=False, reshuffle=True, device=None, out=None):
    import torch

    from safe_control_gym_torch.baseline import cfg_rl_figure8
    from safe_control_gym_torch.controllers.ppo import PPO
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.utils.device import card_line, resolve_device

    dev = resolve_device(device)
    env = make_quadrotor(cfg_rl_figure8(), device=dev)
    ppo = PPO(env, seed=0, rollout_batch_size=batch, rollout_steps=steps, opt_epochs=10,
              mini_batch_size=batch * steps // 4, use_fast_rollout=fast,
              reshuffle_each_epoch=reshuffle)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    state = ppo.state
    for _ in range(2):
        state, _ = ppo._train_step(state)
    sync()
    before = launch_counts()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = ppo._train_step(state)
    sync()
    dt = time.perf_counter() - t0
    record = {
        "metric": "ppo_train_env_steps_per_sec",
        "value": iters * batch * steps / dt,
        "unit": "env-steps/s (collection + GAE + 10 epochs of minibatch steps)",
        "batch": batch, "rollout_steps": steps, "iters": iters,
        "collector": "fast_policy_kernel" if fast else "general_engine",
        "reshuffle_each_epoch": reshuffle,
        "train_step_ms": dt / iters * 1e3,
        "launches_per_train_step": {k: (v - before[k]) / iters
                                    for k, v in launch_counts().items()},
        "policy_loss": float(metrics["policy_loss"]),
        "card": card_line(dev),
    }
    print(json.dumps(record), flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--fast", action="store_true", help="collect with K3 (policy in the kernel)")
    p.add_argument("--once-per-step-shuffle", action="store_true",
                   help="one minibatch shuffle a train step (reshuffle_each_epoch=False)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default=None)
    a = p.parse_args()
    main(a.batch, a.steps, a.iters, a.fast, not a.once_per_step_shuffle, a.device, a.out)
