#!/usr/bin/env python3
"""Verbose API walkthrough on the port: the counterpart of
``examples/verbose_api.py`` (the reference's tests/scripts/verbose_api.py).

Builds an env from a full-featured config (constraints, all three
disturbance channels, randomization), takes two steps and prints the
obs/reward/done/info structure the API returns.  Runs on the card unless
``--device cpu``:

    python3 scripts/verbose_api_port.py --task {cartpole,quadrotor}
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

COMMON = dict(
    task="traj_tracking",
    cost="quadratic",
    randomized_init=True,
    randomized_inertial_prop=True,
    done_on_violation=True,
    disturbances={
        "observation": ({"disturbance_func": "white_noise", "std": 0.01},),
        "action": ({"disturbance_func": "impulse", "magnitude": 0.01,
                    "step_offset": 2, "duration": 1},),
        "dynamics": ({"disturbance_func": "white_noise", "std": 0.001},),
    },
    constraints=(
        {"constraint_form": "default_constraint", "constrained_variable": "input"},
        {"constraint_form": "default_constraint", "constrained_variable": "state"},
    ),
)


def main(task="cartpole", device=None):
    import torch

    from safe_control_gym_torch.envs.cartpole import CartPoleConfig, make_cartpole
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor
    from safe_control_gym_torch.ops.ctr_prng import key_env_seed

    if task == "cartpole":
        env = make_cartpole(CartPoleConfig(ctrl_freq=50, pyb_freq=50, episode_len_sec=10,
                                           **COMMON), device=device)
    else:
        env = make_quadrotor(QuadrotorConfig(quad_type=2, ctrl_freq=60, pyb_freq=240,
                                             episode_len_sec=10, **COMMON), device=device)
    print(f"== {task} ({env.device}) ==")
    print("state_dim:", env.spaces.state_dim, " action_dim:", env.spaces.action_dim,
          " obs_dim:", env.spaces.obs_dim)
    print("action box:", env.spaces.action_low, env.spaces.action_high)
    seeds = torch.full((1,), key_env_seed(7), dtype=torch.int32, device=env.device)
    state, obs, info = env.reset(seeds)
    print("\nreset -> obs:", obs[0].cpu().numpy())
    print("reset info keys:", sorted(info))
    print("symbolic model: nx=%d nu=%d dt=%s" % (env.symbolic.nx, env.symbolic.nu,
                                                  env.symbolic.dt))
    action = torch.as_tensor(np.asarray(env.u_goal, np.float32)[None], device=env.device)
    for i in range(2):
        state, obs, reward, done, info = env.step(state, action)
        print(f"\nstep {i}: reward={float(reward[0]):.4f} done={bool(done[0])}")
        print("  obs:", obs[0].cpu().numpy())
        for k in sorted(info):
            v = info[k][0].cpu().numpy()
            print(f"  info[{k}]: shape={v.shape} value={v if v.size <= 12 else v.ravel()[:6]}")
    return env


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--task", type=str, default="cartpole", choices=["cartpole", "quadrotor"])
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    a = p.parse_args()
    main(a.task, a.device)
