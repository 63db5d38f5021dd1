#!/usr/bin/env python3
"""Fly a sim2real rehearsal scenario on the port and record a video: the
counterpart of ``examples/scenario_rehearsal.py`` (the reference's
dev-sim2real workflow, each scenario directory's getting_started.py).

One of the 12 scenarios flies through the 500 Hz firmware-in-the-loop stack
(``FirmwareWrapper``, its fused block: one copy in and one read out a
control step); a ``FrameRecorder`` keeps every ``render_every``-th frame and
writes a GIF.  Prints the tracked setpoints' mean and largest error.  Runs
on the card unless ``--device cpu``:

    python3 scripts/scenario_rehearsal_port.py --scenario ellipse --out results/rehearsal
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

LEVEL = {
    "task": "stabilization",
    "task_info": {"stabilization_goal": [0, 0, 1], "stabilization_goal_tolerance": 0.15},
    "episode_len_sec": 25,
    "done_on_completion": False,
}


def main(scenario="ellipse", out_dir="results/rehearsal", ctrl_freq=30, firmware_freq=500,
         render_every=3, video=True, device=None):
    from safe_control_gym_torch.competition.competition_utils import Command, dispatch_command
    from safe_control_gym_torch.competition.getting_started import _env_config_from_level
    from safe_control_gym_torch.competition.scenarios import ScenarioController
    from safe_control_gym_torch.controllers.firmware import FirmwareWrapper
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor
    from safe_control_gym_torch.utils.rendering import FrameRecorder

    os.makedirs(out_dir, exist_ok=True)
    env = make_quadrotor(_env_config_from_level(LEVEL, firmware_freq, firmware_freq),
                         device=device)
    wrapper = FirmwareWrapper(env, firmware_freq, ctrl_freq, fused=True)
    ctrl = ScenarioController(scenario, ctrl_freq=ctrl_freq)
    rec = FrameRecorder(env, every=render_every, trajectory=ctrl.reference()) if video else None

    obs, _ = wrapper.reset(seed=0)
    action = np.asarray(env.spaces.action_low, np.float64).copy()
    errs = []
    steps = int((ctrl.scenario.trajectory_length + 9) * ctrl_freq)
    for i in range(steps):
        t = i / ctrl_freq
        command, args = ctrl.cmdFirmware(t, obs)
        if command == Command.FULLSTATE:
            pos = np.array([obs[0], obs[2], obs[4]])
            errs.append(float(np.linalg.norm(pos - np.asarray(args[0]))))
        dispatch_command(wrapper, command, args, t=t)
        obs, reward, done, info, action = wrapper.step(t, action)
        if rec is not None:
            rec.capture(np.asarray(obs))
        if command == Command.FINISHED:
            break
    errs = np.asarray(errs) if errs else np.zeros(1)
    print(f"scenario={scenario} ({env.device}): {len(errs)} tracked setpoints, "
          f"mean err={errs.mean():.3f} m, max={errs.max():.3f} m")
    if rec is not None and rec.frames:
        path = rec.save(os.path.join(out_dir, f"{scenario}.gif"), fps=ctrl_freq // render_every)
        print("video:", path)
    return errs


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from safe_control_gym_torch.competition.scenarios import SCENARIOS

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scenario", default="ellipse", choices=sorted(SCENARIOS))
    p.add_argument("--out", default="results/rehearsal")
    p.add_argument("--no-video", action="store_true")
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    a = p.parse_args()
    main(a.scenario, a.out, video=not a.no_video, device=a.device)
