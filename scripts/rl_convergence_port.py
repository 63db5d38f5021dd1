#!/usr/bin/env python3
"""PPO learning parity of the port's two collectors at convergence scale.

The port's counterpart of ``benchmarks/rl_convergence.py``, with its
protocol: three tasks (CartPole stabilization, the 2D-quadrotor
stabilization task, and 3D-quadrotor figure-8 tracking), each trained twice
from the same seed:

  * ``general``: the general engine collects (``use_fast_rollout=False``:
    ``make_vec_env`` + the env's step, K1 once a step on the 3D quadrotor);
  * ``fast``: the policy kernel of the env's family collects (K6, K8 or K3,
    one launch a train step).

Both update through ``use_fast_update="auto"`` (K4 on the card), as the JAX
harness's two rows both took its update kernel.  B = 1024 envs, T = 64
steps a train step, minibatches of B T / 4, 10 epochs, GAE; the general
collector reshuffles every epoch and the fast one shuffles once a train
step, as in the JAX harness.  Every ``eval_every`` train steps the policy is
evaluated through ``PPO.run``: 64 episodes on the general engine, mode
actions, seed 7.

The artifact is one JSON line: each task's learning curves, final returns,
tracking RMSE (the square root of the mean ``mse`` over the evaluation),
the ratio of the fast collector's final return to the general one's and
the bar "within 5%, or better", training env-steps/s per collector (host
clock around the train steps, synchronized), the kernel launches of each
run's train steps (evaluations left out), and the card's name and power
limit.

    python3 scripts/rl_convergence_port.py [--out results.json]

Needs one CUDA card; ``--device cpu`` (with small ``--*-steps``) runs the
plain versions on the CPU to rehearse the control flow.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from safe_control_gym_torch.baseline import cfg_cartpole_rl, cfg_quad2d_rl  # noqa: E402
from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig  # noqa: E402

BAR = 0.05  # fast final return within 5% of the general one's, or better
SEED, EVAL_SEED = 0, 7


def cfg_quad3d_figure8() -> QuadrotorConfig:
    """quad3d_figure8 (benchmarks/rl_convergence.py:57-70)."""
    return QuadrotorConfig(
        quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=6, task="traj_tracking",
        task_info={"trajectory_type": "figure8", "trajectory_plane": "xy",
                   "trajectory_position_offset": [0, 0], "trajectory_scale": 1.0,
                   "num_cycles": 1, "proj_point": [0, 0, 0.5], "proj_normal": [0, 1, 1]},
        cost="rl_reward", normalized_rl_action_space=True, randomized_inertial_prop=True)


def make_env(cfg, device):
    from safe_control_gym_torch.envs.cartpole import CartPoleConfig, make_cartpole
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor

    make = make_cartpole if isinstance(cfg, CartPoleConfig) else make_quadrotor
    return make(cfg, device=device)


def launch_counters():
    """The wrappers of the kernels a training run can launch: K1 (general
    engine, 3D), the three policy kernels and K4."""
    from safe_control_gym_torch.ops import quad_substeps
    from safe_control_gym_torch.parallel import fast_cartpole, fast_policy, fast_quad_planar
    from safe_control_gym_torch.parallel import fast_update

    return {"k1": quad_substeps.quad3d_substeps, "k3": fast_policy.policy_rollout,
            "k4": fast_update.ppo_grads, "k6": fast_cartpole.cartpole_policy_rollout,
            "k8": fast_quad_planar.planar_policy_rollout}


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def train_one(cfg, fast, total_steps, args, eval_steps, device):
    import torch

    from safe_control_gym_torch.controllers.ppo import PPO

    B, T = args.batch, args.horizon
    ppo = PPO(make_env(cfg, device), seed=SEED, rollout_batch_size=B, rollout_steps=T,
              opt_epochs=10, mini_batch_size=B * T // 4, use_gae=True, use_fast_rollout=fast,
              reshuffle_each_epoch=not fast)

    def evaluate():
        r = ppo.run(num_episodes=args.eval_eps, max_steps=eval_steps, seed=EVAL_SEED)
        return float(np.mean(r["ep_returns"])), float(np.sqrt(np.mean(r["mse"])))

    n_iters = max(int(total_steps) // (B * T), 1)
    chunk = min(args.eval_every, n_iters)
    run_chunk = ppo.train_many(chunk)
    ret0, rmse0 = evaluate()
    curve = [{"env_steps": 0, "return": ret0, "rmse": rmse0}]
    counters = launch_counters()
    launches = dict.fromkeys(counters, 0)
    t0, t_train, done_iters = time.perf_counter(), 0.0, 0
    while done_iters < n_iters:
        n = min(chunk, n_iters - done_iters)
        for fn in counters.values():
            fn.launches = 0
        sync(device)
        ta = time.perf_counter()
        ppo.state, metrics = (run_chunk if n == chunk else ppo.train_many(n))(ppo.state)
        sync(device)
        t_train += time.perf_counter() - ta
        launches = {k: launches[k] + fn.launches for k, fn in counters.items()}
        done_iters += n
        ret, rmse = evaluate()
        curve.append({"env_steps": done_iters * B * T, "return": ret, "rmse": rmse,
                      "policy_loss": float(metrics["policy_loss"])})
        print(json.dumps({"fast": fast, **curve[-1]}), flush=True)
    wall = time.perf_counter() - t0
    if not all(np.isfinite(c["return"]) and np.isfinite(c["rmse"]) for c in curve):
        raise RuntimeError(f"non-finite evaluation in {curve}")
    return {
        "collector": "fast" if fast else "general",
        "update": "k4" if ppo._fu is not None else "autograd",
        "env_steps": n_iters * B * T,
        "return_initial": curve[0]["return"],
        "return_final": curve[-1]["return"],
        "rmse_final": curve[-1]["rmse"],
        "train_wall_s": t_train,
        "wall_s_incl_eval": wall,
        "steps_per_sec_train": n_iters * B * T / max(t_train, 1e-9),
        "launches": launches,
        "curve": curve,
        "torch_device": str(torch.device(device)),
    }


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cartpole-steps", type=float, default=8e6,
                    help="env steps of CartPole and of the 2D quadrotor")
    ap.add_argument("--quad-steps", type=float, default=25e6, help="env steps of the 3D figure-8")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=64)
    ap.add_argument("--eval-every", type=int, default=16, help="train steps between evaluations")
    ap.add_argument("--eval-eps", type=int, default=64)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from safe_control_gym_torch import kernels
    from safe_control_gym_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        kernels.lib()  # build once, outside every timed region
    tasks = []
    for name, cfg, steps, eval_steps in (
            ("cartpole_stab", cfg_cartpole_rl(), args.cartpole_steps, 250),
            ("quad2d_stab_reference_task", cfg_quad2d_rl(), args.cartpole_steps, 300),
            ("quad3d_figure8", cfg_quad3d_figure8(), args.quad_steps, 360)):
        rows = []
        for fast in (False, True):
            rows.append(train_one(cfg, fast, steps, args, eval_steps, device))
            print(json.dumps({"task": name, **{k: v for k, v in rows[-1].items() if k != "curve"}}),
                  flush=True)
        general, fastr = rows
        parity = fastr["return_final"] / general["return_final"] \
            if general["return_final"] else float("nan")
        tasks.append({
            "task": name, "rows": rows,
            "final_return_parity_fast_over_general": parity,
            "parity_within_5pct": bool(abs(parity - 1.0) <= BAR or parity > 1.0),
            "train_speedup_fast_over_general": general["train_wall_s"] / max(fastr["train_wall_s"],
                                                                             1e-9),
        })
    on_card = device.type == "cuda"
    artifact = {
        "metric": "rl_learning_parity_convergence_port",
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "card": card_line() if on_card else None},
        "torch": torch.__version__,
        "protocol": {"batch": args.batch, "horizon": args.horizon, "opt_epochs": 10,
                     "mini_batch_size": args.batch * args.horizon // 4,
                     "eval_every_train_steps": args.eval_every, "eval_episodes": args.eval_eps,
                     "eval_seed": EVAL_SEED, "seed": SEED, "bar": BAR},
        "tasks": tasks,
    }
    line = json.dumps(artifact)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    for t in tasks:
        g, f = t["rows"]
        print(f"{t['task']}: final return general {g['return_final']:.4f} fast "
              f"{f['return_final']:.4f} (parity {t['final_return_parity_fast_over_general']:.4f}, "
              f"within {BAR:.0%}: {t['parity_within_5pct']}); rmse {g['rmse_final']:.4f} / "
              f"{f['rmse_final']:.4f}; train env-steps/s {g['steps_per_sec_train']:.6g} / "
              f"{f['steps_per_sec_train']:.6g}")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
