#!/usr/bin/env python3
"""A/B of PPO learning with the general-engine collector against the
policy-in-kernel collector (K3), the counterpart of
``benchmarks/rl_equivalence.py``.

On ``baseline.cfg_rl_figure8``, the same initialization (seed 0) and
evaluation (``ppo.run`` over 64 episodes of 360 steps on the general
engine, evaluation seed 7); only the collector differs.  40 train iterations at 1024 envs x 64 steps, GAE, 10
epochs of 4 minibatches (one shuffle a step with the fast collector, as the
JAX harness).  The gates of the JAX harness: each collector improves the
evaluation return by more than 0.02, and the fast one's improvement is more
than half the general engine's.  Prints one JSON line per collector and a
summary with ``passed``; exits non-zero where a gate fails; writes the
summary only under ``--out``.

    python3 scripts/rl_equivalence_port.py [--iters 40] [--batch 1024]
        [--steps 64] [--device cpu] [--out results/rl_equivalence.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEARN_MARGIN = 0.02  # benchmarks/rl_equivalence.py's asserts
MIN_RATIO = 0.5


def train(env, fast, n_iters, batch, steps, eval_episodes, eval_steps):
    from safe_control_gym_torch.controllers.ppo import PPO

    ppo = PPO(env, seed=0, rollout_batch_size=batch, rollout_steps=steps, opt_epochs=10,
              mini_batch_size=batch * steps // 4, use_gae=True, use_fast_rollout=fast,
              reshuffle_each_epoch=not fast)
    def evaluate():
        return float(ppo.run(num_episodes=eval_episodes, max_steps=eval_steps,
                             seed=7)["ep_returns"].mean())

    r0 = evaluate()
    t0 = time.perf_counter()
    s = ppo.state
    for _ in range(n_iters):
        s, _ = ppo._train_step(s)
    ppo.state = s
    r1 = evaluate()
    return {"collector": "fast_policy_kernel" if fast else "general_engine",
            "return_before": r0, "return_after": r1, "train_s": time.perf_counter() - t0}


def main(n_iters=40, batch=1024, steps=64, eval_episodes=64, eval_steps=360, device=None,
         out=None):
    from safe_control_gym_torch.baseline import cfg_rl_figure8
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.utils.device import card_line, resolve_device

    dev = resolve_device(device)
    env = make_quadrotor(cfg_rl_figure8(), device=dev)
    runs = []
    for fast in (False, True):
        runs.append(train(env, fast, n_iters, batch, steps, eval_episodes, eval_steps))
        print(json.dumps(runs[-1]), flush=True)
    gain = [r["return_after"] - r["return_before"] for r in runs]
    ratio = gain[1] / gain[0] if gain[0] != 0 else None
    record = {"metric": "fast_over_general_improvement_ratio", "value": ratio,
              "general_engine_learned": gain[0] > LEARN_MARGIN,
              "fast_learned": gain[1] > LEARN_MARGIN,
              "ratio_above_half": ratio is not None and ratio > MIN_RATIO,
              "iters": n_iters, "batch": batch, "rollout_steps": steps, "runs": runs,
              "card": card_line(dev)}
    record["passed"] = (record["general_engine_learned"] and record["fast_learned"]
                        and record["ratio_above_half"])
    print(json.dumps(record), flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=40)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--eval-episodes", type=int, default=64)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default=None)
    a = p.parse_args()
    sys.exit(0 if main(a.iters, a.batch, a.steps, a.eval_episodes, device=a.device,
                       out=a.out)["passed"] else 1)
