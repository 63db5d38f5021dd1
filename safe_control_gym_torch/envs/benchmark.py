"""Benchmark-environment core: tasks, costs, timing, reference trajectories.

Port of ``safe_control_gym_tpu/envs/benchmark.py``.  An environment is an
``FnEnv``: a bundle of functions on batched ``(B, ...)`` tensors produced by
a factory from a static config.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class Cost(str, Enum):
    """Reward/cost function choice (reference benchmark_env.py:19-27)."""

    RL_REWARD = "rl_reward"
    QUADRATIC = "quadratic"
    COMPETITION = "competition"


class Task(str, Enum):
    """Environment task (reference benchmark_env.py:29-36)."""

    STABILIZATION = "stabilization"
    TRAJ_TRACKING = "traj_tracking"


class EnvSpaces(NamedTuple):
    """Static box-space description (host NumPy arrays)."""

    state_low: np.ndarray
    state_high: np.ndarray
    action_low: np.ndarray
    action_high: np.ndarray
    obs_low: np.ndarray
    obs_high: np.ndarray

    @property
    def state_dim(self) -> int:
        return self.state_low.shape[0]

    @property
    def action_dim(self) -> int:
        return self.action_low.shape[0]

    @property
    def obs_dim(self) -> int:
        return self.obs_low.shape[0]


@dataclasses.dataclass(frozen=True)
class FnEnv:
    """A functional, batched environment.

    Attributes:
        reset: ``(env_seeds) -> (state, obs, info)`` over a batch of int32
            env seeds; every per-episode draw derives from the counter PRNG.
        step: ``(state, action) -> (state, obs, reward, done, info)``.
        spaces: static space description.
        config: the static config the env was built from.
        x_goal / u_goal: reference state(s) and input (host arrays).
        ctrl_freq / pyb_freq / episode_len_sec: timing constants.
        device: the torch device the env's tensors live on.
        extras: env-specific extra functions (``reset_episode``).
        symbolic: the env's a-priori closed-form model, a
            ``models.dynamics_model.DynamicsModel`` (the reference ships a
            CasADi model to its controllers through reset info).
    """

    reset: Callable
    step: Callable
    spaces: EnvSpaces
    config: Any
    x_goal: np.ndarray
    u_goal: np.ndarray
    ctrl_freq: int
    pyb_freq: int
    episode_len_sec: float
    device: torch.device
    extras: Any = None
    symbolic: Any = None

    @property
    def ctrl_timestep(self) -> float:
        return 1.0 / self.ctrl_freq

    @property
    def max_episode_steps(self) -> int:
        return int(self.episode_len_sec * self.ctrl_freq)


def where_state(mask, a, b):
    """Field-wise ``where(mask, a, b)`` of two env-state dataclasses of one
    type, for a (B,) bool mask (nested dicts of tensors included)."""

    def sel(u, v):
        if isinstance(u, dict):
            return {k: sel(u[k], v[k]) for k in u}
        m = mask.reshape(mask.shape + (1,) * (u.dim() - 1))
        return torch.where(m, u, v)

    return type(a)(**{f.name: sel(getattr(a, f.name), getattr(b, f.name))
                      for f in dataclasses.fields(a)})


def check_timing(pyb_freq: int, ctrl_freq: int) -> int:
    """Validate physics/control frequency divisibility
    (reference benchmark_env.py:154-156)."""
    if pyb_freq % ctrl_freq != 0:
        raise ValueError("pyb_freq must be divisible by ctrl_freq.")
    return pyb_freq // ctrl_freq


# ---------------------------------------------------------------------------
# Reference trajectory generation (host-side, float64 NumPy), computed once
# at env-build time (reference benchmark_env.py:465-674).
# ---------------------------------------------------------------------------

_AXES = {"x": 0, "y": 1, "z": 2}


def _figure8(t, period, scaling):
    w = 2.0 * np.pi / period
    a = scaling * np.sin(w * t)
    b = scaling * np.sin(w * t) * np.cos(w * t)
    a_dot = scaling * w * np.cos(w * t)
    b_dot = scaling * w * (np.cos(w * t) ** 2 - np.sin(w * t) ** 2)
    return a, b, a_dot, b_dot


def _circle(t, period, scaling):
    w = 2.0 * np.pi / period
    return (
        scaling * np.cos(w * t),
        scaling * np.sin(w * t),
        -scaling * w * np.sin(w * t),
        scaling * w * np.cos(w * t),
    )


def _square(t, period, scaling):
    seg_period = period / 4.0
    speed = scaling / seg_period
    cycle_time = t % period
    seg_time = cycle_time % seg_period
    seg_idx = np.floor(cycle_time / seg_period).astype(int)
    seg_pos = speed * seg_time
    # Piecewise segments: up, left, down, right (benchmark_env.py:650-674).
    segs = [seg_idx == k for k in range(4)]
    zero = 0.0 * seg_pos
    a = np.select(segs, [zero, -seg_pos, -scaling + zero, -scaling + seg_pos])
    b = np.select(segs, [seg_pos, scaling + zero, scaling - seg_pos, zero])
    a_dot = np.select(segs, [zero, -speed + zero, zero, speed + zero])
    b_dot = np.select(segs, [speed + zero, zero, -speed + zero, zero])
    return a, b, a_dot, b_dot


_TRAJ_FNS = {"figure8": _figure8, "circle": _circle, "square": _square}


def generate_trajectory(
    traj_type: str = "figure8",
    traj_length: float = 10.0,
    num_cycles: int = 1,
    traj_plane: str = "xy",
    position_offset=(0.0, 0.0),
    scaling: float = 1.0,
    sample_time: float = 0.01,
):
    """Sample a planar reference trajectory; returns (pos, vel, speed),
    float64 arrays with times = arange(0, length, sample_time)."""
    if traj_type not in _TRAJ_FNS:
        raise ValueError("Trajectory type should be one of [circle, square, figure8].")
    if (
        len(traj_plane) != 2
        or traj_plane[0] not in _AXES
        or traj_plane[1] not in _AXES
        or traj_plane[0] == traj_plane[1]
    ):
        raise ValueError("Trajectory plane should be two distinct axes from {x, y, z}.")
    period = traj_length / num_cycles
    ia, ib = _AXES[traj_plane[0]], _AXES[traj_plane[1]]
    times = np.arange(0.0, traj_length, sample_time)
    a, b, a_dot, b_dot = _TRAJ_FNS[traj_type](times, period, scaling)
    pos = np.zeros((times.shape[0], 3))
    vel = np.zeros((times.shape[0], 3))
    pos[:, ia] = a + position_offset[0]
    pos[:, ib] = b + position_offset[1]
    vel[:, ia] = a_dot
    vel[:, ib] = b_dot
    speed = np.linalg.norm(vel, axis=-1, keepdims=True)
    return pos, vel, speed
