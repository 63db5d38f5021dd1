#!/usr/bin/env python3
"""PID trajectory tracking on the port: the counterpart of
``examples/tracking.py`` (the reference's tests/scripts/tracking.py).

A 2D quadrotor tracks a circle with the DSL PID controller; the flight is
logged by a ``DroneLogger``, and the script prints steps/s, the real-time
speedup (tracking.py:78-80) and the tracking RMSE.  Runs on the card unless
``--device cpu``:

    python3 scripts/tracking_port.py [--max_steps N] [--plot out.png]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

CONFIG = dict(
    quad_type=2, task="traj_tracking", cost="rl_reward",
    task_info={"trajectory_type": "circle", "num_cycles": 1, "trajectory_plane": "zx",
               "trajectory_position_offset": [0.5, 0], "trajectory_scale": -0.5},
    episode_len_sec=6, ctrl_freq=50, pyb_freq=50, randomized_init=False,
    init_state={"init_x": 0.0, "init_z": 1.0},
)


def main(max_steps=None, plot=None, device=None):
    import torch

    from safe_control_gym_torch.controllers.pid import PID
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor
    from safe_control_gym_torch.ops.ctr_prng import key_env_seed
    from safe_control_gym_torch.utils.drone_logger import DroneLogger

    env = make_quadrotor(QuadrotorConfig(**CONFIG), device=device)
    pid = PID(env)
    logger = DroneLogger(logging_freq_hz=env.ctrl_freq)
    seeds = torch.full((1,), key_env_seed(0), dtype=torch.int32, device=env.device)
    state, obs, _ = env.reset(seeds)
    o = obs[0].cpu().numpy()
    T = max_steps or env.max_episode_steps
    start = time.time()
    total_mse = 0.0
    for i in range(T):
        action = pid.select_action(o)
        a = torch.as_tensor(np.asarray(action, np.float32).reshape(1, -1), device=env.device)
        state, obs, reward, done, info = env.step(state, a)
        out = torch.cat([obs[0], info["mse"], done.to(obs.dtype)]).cpu().numpy()
        o = out[:6]
        logger.log(0, i / env.ctrl_freq, [o[0], 0, o[2], o[1], 0, o[3], 0, o[4], 0, 0, o[5], 0])
        total_mse += float(out[6])
        if out[7] > 0.5:
            break
    elapsed = time.time() - start
    n = i + 1
    print(f"steps/sec: {n / elapsed:.1f} ({env.device})")
    print(f"realtime speedup: {(n / env.ctrl_freq) / elapsed:.2f}x")
    print(f"rmse: {np.sqrt(total_mse / n):.4f}")
    if plot:
        logger.plot(plot)
        print(f"saved plot to {plot}")
    return np.sqrt(total_mse / n)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--plot", type=str, default=None)
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    a = p.parse_args()
    main(a.max_steps, a.plot, a.device)
