"""Competition utilities.

Port of ``safe_control_gym_tpu/competition/competition_utils.py`` (the
counterpart of reference competition/competition_utils.py): the firmware
Command enum (:16-36), timing decorators (:250-282), trajectory drawing
helpers (``utils/rendering.py``) and :func:`thrusts`, which runs the port's
``pid_control`` on a batch of one on the device.
"""

from __future__ import annotations

import time
from enum import Enum
from functools import wraps

import numpy as np


class Command(Enum):
    """High-level firmware commands (reference competition_utils.py:16-36)."""

    FINISHED = -1
    NONE = 0
    FULLSTATE = 1
    TAKEOFF = 2
    LAND = 3
    STOP = 4
    GOTO = 5
    NOTIFYSETPOINTSTOP = 6


def timing_step(fn):
    """Accumulate per-step compute time on the instance
    (reference competition_utils.py:250-264)."""

    @wraps(fn)
    def wrapped(self, *args, **kwargs):
        start = time.time()
        out = fn(self, *args, **kwargs)
        elapsed = time.time() - start
        self.interstep_learning_time = getattr(self, "interstep_learning_time", 0.0) + elapsed
        self.interstep_learning_occurrences = getattr(self, "interstep_learning_occurrences", 0) + 1
        return out

    return wrapped


def timing_ep(fn):
    """Accumulate per-episode compute time (reference :266-282)."""

    @wraps(fn)
    def wrapped(self, *args, **kwargs):
        start = time.time()
        out = fn(self, *args, **kwargs)
        self.interepisode_learning_time = time.time() - start
        return out

    return wrapped


def dispatch_command(firmware_wrapper, command: Command, args, t=None):
    """Map a Command to the firmware API (reference getting_started.py:175-190).

    FULLSTATE args may be reference-style ``[pos, vel, acc, yaw, rpy_rates]``
    (the dispatch loop appends the current time, as the reference does at
    getting_started.py:176) or carry an explicit trailing timestep.
    """
    if command == Command.FULLSTATE:
        if len(args) == 5:
            args = (*args, 0.0 if t is None else t)
        firmware_wrapper.sendFullStateCmd(*args)
    elif command == Command.TAKEOFF:
        firmware_wrapper.sendTakeoffCmd(*args)
    elif command == Command.LAND:
        firmware_wrapper.sendLandCmd(*args)
    elif command == Command.STOP:
        firmware_wrapper.sendStopCmd()
    elif command == Command.GOTO:
        firmware_wrapper.sendGotoCmd(*args)
    elif command == Command.NOTIFYSETPOINTSTOP:
        firmware_wrapper.sendNotifySetpointStop()
    elif command in (Command.NONE, Command.FINISHED):
        pass
    else:
        raise ValueError(f"unknown command {command}")


def plot_trajectory_3d(points, out_path: str):
    """Save a 3D plot of a planned trajectory (reference :284-337)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    points = np.asarray(points)
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.plot(points[:, 0], points[:, 1], points[:, 2])
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_trajectory(t_scaled, waypoints, ref_x, ref_y, ref_z,
                    out_path=None, show=False):
    """Per-axis + 3D reference-trajectory plots (reference
    competition_utils.py:284-311).  Headless-first: saves to ``out_path``
    (suffixes _axes/_3d) instead of blocking GUI windows; ``show=True``
    restores the reference's interactive behavior."""
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    import numpy as np

    waypoints = np.asarray(waypoints)
    fig, axs = plt.subplots(3, 1, sharex=True)
    for ax, ref, lbl in zip(axs, (ref_x, ref_y, ref_z), ("x (m)", "y (m)", "z (m)")):
        ax.plot(t_scaled, ref)
        ax.set_ylabel(lbl)
    paths = []
    if out_path:
        p1 = out_path.replace(".png", "") + "_axes.png"
        fig.savefig(p1)
        paths.append(p1)
    if show:
        plt.show(block=False)
        plt.pause(2)
    plt.close(fig)

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.plot(ref_x, ref_y, ref_z)
    if waypoints.size:
        ax.scatter(waypoints[:, 0], waypoints[:, 1], waypoints[:, 2])
    if out_path:
        p2 = out_path.replace(".png", "") + "_3d.png"
        fig.savefig(p2)
        paths.append(p2)
    if show:
        plt.show(block=False)
        plt.pause(2)
    plt.close(fig)
    return paths


def draw_trajectory(initial_info, waypoints, ref_x, ref_y, ref_z,
                    out_path=None):
    """Reference competition_utils.py:313-337 draws the plan into PyBullet's
    GUI; without a GUI this renders the plan over the maze to an image via
    utils/rendering.py (waypoint markers + reference line)."""
    import numpy as np

    from safe_control_gym_torch.utils.rendering import render_quadrotor

    traj = np.stack([ref_x, ref_y, ref_z], axis=-1)
    x0 = np.zeros(12)
    x0[0], x0[2], x0[4] = ref_x[0], ref_y[0], ref_z[0]
    frame = render_quadrotor(
        x0,
        gates=initial_info.get("nominal_gates_pos_and_type"),
        obstacles=initial_info.get("nominal_obstacles_pos"),
        trajectory=traj,
    )
    if out_path:
        from PIL import Image

        Image.fromarray(frame).save(out_path)
    return frame


def thrusts(controller, ctrl_timestep, kf, obs, target, target_v, device=None):
    """PID -> per-motor thrusts for cmdSimOnly users (reference
    competition_utils.py:338-356).  ``controller`` carries a PIDState in
    ``controller.pid_state`` (created on first use); the PID runs on
    ``device`` (CUDA unless the caller names one) on a batch of one, its
    inputs copied there in one go."""
    import torch

    from safe_control_gym_torch.controllers.pid import PIDState, pid_control
    from safe_control_gym_torch.utils.device import resolve_device

    dev = resolve_device(device)
    state = getattr(controller, "pid_state", None)
    if state is None:
        state = PIDState.create((1,), device=dev)
    obs = np.asarray(obs)
    rows = np.stack([obs[[0, 2, 4]], obs[6:9], obs[[1, 3, 5]], np.asarray(target).reshape(3),
                     np.asarray(target_v).reshape(3)]).astype(np.float32)
    pos, rpy, vel, tgt, tgt_v = torch.from_numpy(rows).to(dev)[:, None].unbind(0)
    rpm, state, _, _ = pid_control(state, ctrl_timestep, pos, rpy, vel, tgt, target_vel=tgt_v)
    controller.pid_state = state
    return kf * rpm[0].cpu().numpy().astype(np.float64) ** 2
