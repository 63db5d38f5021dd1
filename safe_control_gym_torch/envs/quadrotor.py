"""Quadrotor environment (1D, 2D and 3D) on batched PyTorch tensors.

Port of ``safe_control_gym_tpu/envs/quadrotor.py``: the thrust -> PWM ->
RPM -> force actuation (with the 1D/2D motor grouping of ``cmd2pwm``),
``pyb`` (RK4) and ``dyn`` (explicit Euler) physics and the aero modes
``pyb_gnd`` (ground effect), ``pyb_drag`` (drag), ``pyb_dw`` (downwash: no
effect on a single drone) and ``pyb_gnd_drag_dw`` (``_aero``,
base_aviary.py:437-496), stabilization and figure8/circle/square
trajectory tracking, ``rl_reward``, ``quadratic`` and ``competition`` costs,
every constraint form (``envs/constraints.py``), every disturbance kind
(``envs/disturbances.py``) with any number of randomized step offsets, the
adversary channel (``set_adversary_control`` in ``extras``, RARL/RAP's),
the competition maze (gates and obstacles with their per-episode pose
randomization, collision, gate progress and completion, ``envs/gates.py``),
out-of-bound / collision / completion done flags, time-limit truncation
and the non-finite freeze.  The 3D physics runs through the K1 substep
kernel (``ops/quad_substeps.py``) but for the ground-effect and drag modes,
which, as in the JAX package (quadrotor.py:785-789), take the plain
rigid body (``quad_fc_3d``) with the aero terms in every stage; the 1D and
2D bodies (``quad_fc_1d`` / ``quad_fc_2d``), which had no TPU kernel, are
plain PyTorch.  Every env of a batch carries its own randomized inertia
and initial state, drawn from the counter PRNG (``ops/ctr_prng.py``)
exactly as the JAX package draws them; the randomized step offsets other
than a single one on the dynamics channel, which the JAX package draws
from threefry, come from counter slots after the maze's and agree with
the JAX package's in distribution only.  ``env.symbolic`` is the a-priori
model on nominal parameters (``models/dynamics_model.py``), which takes the
commanded thrusts as its input.
"""

from __future__ import annotations

import dataclasses
import math
from enum import IntEnum
from typing import Any, Optional

import numpy as np
import torch

from safe_control_gym_torch.envs import benchmark as bm
from safe_control_gym_torch.envs import gates as gate_geom
from safe_control_gym_torch.envs.benchmark import Cost, EnvSpaces, FnEnv, Task
from safe_control_gym_torch.envs.constraints import build_constraints
from safe_control_gym_torch.envs.disturbances import (build_disturbances, num_offset_slots,
                                                       scheduled_offsets)
from safe_control_gym_torch.models.dynamics_model import DynamicsModel
from safe_control_gym_torch.ops import ctr_prng
from safe_control_gym_torch.ops.integrators import rk4_step
from safe_control_gym_torch.ops.quad_substeps import GRAVITY as GRAVITY_ACC
from safe_control_gym_torch.ops.quad_substeps import (  # noqa: F401 (cmd2pwm, pwm2rpm: the env's actuation API)
    ARM_L, KF, MAX_PWM, MIN_PWM, PWM2RPM_CONST, PWM2RPM_SCALE, actuate, cmd2pwm, div, pwm2rpm,
    quad3d_substeps)
from safe_control_gym_torch.ops.rotations import rot_xyz, transform_trajectory
from safe_control_gym_torch.utils.device import resolve_device

BIG = 1e30


class QuadType(IntEnum):
    """Reference quadrotor_utils.py:11-18."""

    ONE_D = 1
    TWO_D = 2
    THREE_D = 3


# cf2x.urdf physical constants (reference base_aviary.py:612-651) beyond
# those the substep kernel holds (ops/quad_substeps.py).
MASS = 0.03454
J_DIAG = (1.4e-5, 1.4e-5, 2.17e-5)
KM = 7.94e-12
GROUND_PLANE_Z = 0.0
THRUST2WEIGHT = 2.25
GND_EFF_COEFF = 11.36859
PROP_RADIUS = 2.31348e-2
DRAG_COEFF = (9.1785e-7, 9.1785e-7, 10.311e-7)
# Derived (base_aviary.py:138-147): the ground effect's height clip.
MAX_RPM = math.sqrt((THRUST2WEIGHT * GRAVITY_ACC * MASS) / (4 * KF))
MAX_THRUST = 4 * KF * MAX_RPM**2
GND_EFF_H_CLIP = 0.25 * PROP_RADIUS * math.sqrt(
    (15 * MAX_RPM**2 * KF * GND_EFF_COEFF) / MAX_THRUST)

# Default randomization infos (reference quadrotor.py:45-134).
_DEFAULT_INERTIAL_RAND = {
    "M": {"distrib": "uniform", "low": 0.022, "high": 0.032},
    "Ixx": {"distrib": "uniform", "low": 1.3e-5, "high": 1.5e-5},
    "Iyy": {"distrib": "uniform", "low": 1.3e-5, "high": 1.5e-5},
    "Izz": {"distrib": "uniform", "low": 2.07e-5, "high": 2.27e-5},
}
_DEFAULT_INIT_RAND = {
    "init_x": {"distrib": "uniform", "low": -0.5, "high": 0.5},
    "init_x_dot": {"distrib": "uniform", "low": -0.01, "high": 0.01},
    "init_y": {"distrib": "uniform", "low": -0.5, "high": 0.5},
    "init_y_dot": {"distrib": "uniform", "low": -0.01, "high": 0.01},
    "init_z": {"distrib": "uniform", "low": 0.1, "high": 1.5},
    "init_z_dot": {"distrib": "uniform", "low": -0.01, "high": 0.01},
    "init_phi": {"distrib": "uniform", "low": -0.3, "high": 0.3},
    "init_theta": {"distrib": "uniform", "low": -0.3, "high": 0.3},
    "init_psi": {"distrib": "uniform", "low": -0.3, "high": 0.3},
    "init_p": {"distrib": "uniform", "low": -0.01, "high": 0.01},
    "init_theta_dot": {"distrib": "uniform", "low": -0.01, "high": 0.01},
    "init_q": {"distrib": "uniform", "low": -0.01, "high": 0.01},
    "init_r": {"distrib": "uniform", "low": -0.01, "high": 0.01},
}
_DEFAULT_TASK_INFO = {
    "stabilization_goal": [0, 1],
    "stabilization_goal_tolerance": 0.05,
    "trajectory_type": "circle",
    "num_cycles": 1,
    "trajectory_plane": "zx",
    "trajectory_position_offset": [0.5, 0],
    "trajectory_scale": -0.5,
    "proj_point": [0, 0, 0.5],
    "proj_normal": [0, 1, 1],
}

INIT_LABELS = ("init_x", "init_x_dot", "init_y", "init_y_dot", "init_z",
               "init_z_dot", "init_phi", "init_theta", "init_psi", "init_p",
               "init_q", "init_r")
OOB_MASK = (1, 0, 1, 0, 1, 0, 1, 1, 1, 0, 0, 0)
NX, NU = 12, 4
_CHANNELS = ("observation", "action", "dynamics")

# Per quad type (quadrotor.py:128-143, :362-404): state and input widths,
# initial-state labels (1D aliases init_x/init_x_dot to z, z_dot), the
# out-of-bound mask, the inertia randomizations kept by default, and the
# state dims of the default mse metric.
TYPE_NX_NU = {1: (2, 1), 2: (6, 2), 3: (NX, NU)}
TYPE_INIT_LABELS = {1: ("init_x", "init_x_dot"),
                    2: ("init_x", "init_x_dot", "init_z", "init_z_dot", "init_theta",
                        "init_theta_dot"),
                    3: INIT_LABELS}
TYPE_OOB_MASK = {1: (1, 0), 2: (1, 0, 1, 0, 1, 0), 3: OOB_MASK}
_TYPE_INERTIAL_KEYS = {1: ("M",), 2: ("M", "Iyy"), 3: ("M", "Ixx", "Iyy", "Izz")}
_TYPE_MSE_W = {1: [1, 0], 2: [1, 0, 1, 0, 0, 0], 3: [1, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0]}
# State names per quad type (quadrotor.py:128); post_analysis wraps the
# errors of the angles among them.
STATE_LABELS = {
    QuadType.ONE_D: ("z", "z_dot"),
    QuadType.TWO_D: ("x", "x_dot", "z", "z_dot", "theta", "theta_dot"),
    QuadType.THREE_D: ("x", "x_dot", "y", "y_dot", "z", "z_dot", "phi", "theta", "psi", "p", "q",
                       "r"),
}


@dataclasses.dataclass(frozen=True)
class QuadrotorConfig:
    """The JAX package's config fields, less the two that only select TPU
    paths (``use_pallas``, ``onehot_goal``)."""

    quad_type: int = 2
    physics: str = "pyb"
    seed: Optional[int] = None
    ctrl_freq: int = 50
    pyb_freq: int = 50
    episode_len_sec: float = 5.0
    task: str = "stabilization"
    task_info: Optional[dict] = None
    cost: str = "rl_reward"
    normalized_rl_action_space: bool = False
    norm_act_scale: float = 0.1
    obs_goal_horizon: int = 0
    # Initial state.
    init_state: Optional[Any] = None
    randomized_init: bool = True
    init_state_randomization_info: Optional[dict] = None
    # Inertial properties.
    inertial_prop: Optional[Any] = None
    prior_prop: Optional[Any] = None
    randomized_inertial_prop: bool = False
    inertial_prop_randomization_info: Optional[dict] = None
    # Constraints.
    constraints: Optional[tuple] = None
    done_on_violation: bool = False
    use_constraint_penalty: bool = False
    constraint_penalty: float = -1.0
    # Disturbances / adversary.
    disturbances: Optional[dict] = None
    adversary_disturbance: Optional[str] = None
    adversary_disturbance_offset: float = 0.0
    adversary_disturbance_scale: float = 0.01
    # Reward shaping.
    rew_state_weight: Any = 1.0
    rew_act_weight: Any = 0.0001
    rew_exponential: bool = True
    done_on_out_of_bound: bool = True
    info_mse_metric_state_weight: Optional[Any] = None
    # Competition maze.
    gates: Optional[tuple] = None
    obstacles: Optional[tuple] = None
    randomized_gates_and_obstacles: bool = False
    gates_and_obstacles_randomization_info: Optional[dict] = None
    done_on_collision: bool = False
    done_on_completion: bool = False
    # Engine.
    dtype: Any = torch.float32
    q_weight: Optional[Any] = None
    r_weight: Optional[Any] = None


@dataclasses.dataclass
class QuadState:
    """Per-env state of a batch; every tensor has a leading (B,) axis."""

    x: torch.Tensor  # (B, 12)
    ctrl_step: torch.Tensor  # int32
    pyb_step: torch.Tensor  # int32
    # Counter-PRNG identity (ops/ctr_prng.py): reset draws are pure
    # functions of (env_seed, episode_idx, slot).
    env_seed: torch.Tensor  # int32
    episode_idx: torch.Tensor  # int32
    mass: torch.Tensor
    j_diag: torch.Tensor  # (B, 3)
    # Per-channel randomized impulse/step offsets, (B, n_scheduled) int32,
    # and brownian walks, (B, walk_dim).
    dist_offsets: dict
    dist_walk: dict
    cnstr_violation: torch.Tensor  # bool
    # The adversary channel's force (B, 3) and action offset (B, nu), set by
    # set_adversary_control for the next step and zeroed by it.
    adv_force: torch.Tensor
    adv_act: torch.Tensor
    # Competition maze state (empty gate/obstacle axes without a maze).
    gates_eff: torch.Tensor  # (B, NG, 4): x, y, yaw, aperture height
    obstacles_eff: torch.Tensor  # (B, NO, 2)
    current_gate: torch.Tensor  # int32
    stepped_through_gate: torch.Tensor  # bool
    currently_collided: torch.Tensor  # bool
    at_goal_pos: torch.Tensor  # bool
    steps_at_goal: torch.Tensor  # int32
    task_completed: torch.Tensor  # bool

    def replace(self, **kw) -> "QuadState":
        return dataclasses.replace(self, **kw)


def motor_force(thrust, n_motor: int):
    """A 1D/2D thrust command -> the force of each of the ``n_motor`` motors
    it drives: the command split evenly (the ``cmd2pwm`` grouping,
    quadrotor.py:239-250), then the 4-motor actuation, cmd2pwm -> clip ->
    pwm2rpm -> rpm^2 * KF."""
    return actuate(div(torch.clamp_min(thrust, 0.0), float(n_motor)))


def planar_forces(thrust, n_motor: int):
    """1D/2D thrust commands (B, nu) -> the 4 motors' forces (B, 4): 1D
    commands all four motors, 2D the pairs (T1, T2, T2, T1)."""
    f = motor_force(thrust, n_motor)
    return f.repeat(1, 4) if f.shape[-1] == 1 else torch.cat([f, f.flip(-1)], -1)


def quad_fc_1d(x, forces, mass, ext_fz, g=GRAVITY_ACC):
    """Vertical quadrotor (quadrotor.py:261-265): x (B, 2), forces (B, 4)."""
    T = forces.sum(-1)
    z_dd = T / mass - g + ext_fz / mass
    return torch.stack([x[..., 1], z_dd], -1)


def quad_fc_2d(x, forces, mass, iyy, ext_fx, ext_fz, g=GRAVITY_ACC):
    """Planar quadrotor in x-z (quadrotor.py:268-279): paired thrusts
    T1 = motors 1 & 4, T2 = motors 2 & 3."""
    T1 = forces[..., 0] + forces[..., 3]
    T2 = forces[..., 1] + forces[..., 2]
    theta = x[..., 4]
    x_dd = torch.sin(theta) * (T1 + T2) / mass + ext_fx / mass
    z_dd = torch.cos(theta) * (T1 + T2) / mass - g + ext_fz / mass
    theta_dd = div(ARM_L * (T2 - T1) / iyy, math.sqrt(2.0))
    return torch.stack([x[..., 1], x_dd, x[..., 3], z_dd, x[..., 5], theta_dd], -1)


def quad_fc_3d(x, forces, mass, j_diag, ext_f, g=GRAVITY_ACC, km_over_kf=KM / KF):
    """Full 3D rigid body (reference quadrotor.py:624-674) on batched
    tensors: x (B, 12), forces (B, 4), mass (B,), j_diag (B, 3),
    ext_f (B, 3) -> x_dot (B, 12)."""
    phi, theta, psi = x[..., 6], x[..., 7], x[..., 8]
    pqr = x[..., 9:12]
    f1, f2, f3, f4 = forces.unbind(-1)
    T = f1 + f2 + f3 + f4
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    zb = torch.stack([cpsi * sth * cphi + spsi * sphi,
                      spsi * sth * cphi - cpsi * sphi, cth * cphi], -1)
    m = mass[..., None]
    # Gravity on z alone (x - 0.0 == x): no gravity vector copied to the
    # device each call.
    acc = zb * T[..., None] / m
    pos_dd = torch.cat([acc[..., :2], acc[..., 2:] - g], -1) + ext_f / m
    l_sq2 = ARM_L / math.sqrt(2.0)
    Mb = torch.stack([l_sq2 * (f1 + f2 - f3 - f4), l_sq2 * (-f1 + f2 + f3 - f4),
                      km_over_kf * (f1 - f2 + f3 - f4)], -1)
    gyro = torch.linalg.cross(pqr, j_diag * pqr)
    rate_dot = (Mb - gyro) / j_diag
    tth = torch.tan(theta)
    p_, q_, r_ = pqr.unbind(-1)
    ang_dot = torch.stack([p_ + sphi * tth * q_ + cphi * tth * r_,
                           cphi * q_ - sphi * r_,
                           sphi / cth * q_ + cphi / cth * r_], -1)
    return torch.cat([torch.stack([x[..., 1], pos_dd[..., 0], x[..., 3], pos_dd[..., 1],
                                   x[..., 5], pos_dd[..., 2]], -1), ang_dot, rate_dot], -1)


def _weights_vec(w, dim):
    w = np.asarray(w, dtype=float).reshape(-1)
    if w.size == 1:
        w = np.full(dim, w[0])
    if w.size != dim:
        raise ValueError(f"weight size {w.size} != {dim}")
    return w


def maze_nominal(cfg: QuadrotorConfig):
    """The config's nominal gates (NG, 7: x, y, z, r, p, yaw, type) and
    obstacles (NO, 6) (quadrotor.py:505-509)."""
    return (np.asarray(cfg.gates if cfg.gates else np.zeros((0, 7)), float).reshape(-1, 7),
            np.asarray(cfg.obstacles if cfg.obstacles else np.zeros((0, 6)), float).reshape(-1, 6))


def make_quadrotor(config: QuadrotorConfig = QuadrotorConfig(), device=None) -> FnEnv:
    """Build the batched quadrotor env on ``device`` (CUDA by default)."""
    cfg = config
    if cfg.physics not in ("pyb", "dyn", "pyb_gnd", "pyb_drag", "pyb_dw", "pyb_gnd_drag_dw"):
        raise ValueError(f"unknown physics mode {cfg.physics!r}")
    if int(cfg.quad_type) not in TYPE_NX_NU:
        raise ValueError(f"unknown quad_type {cfg.quad_type}")
    if cfg.adversary_disturbance not in (None, "action", "dynamics"):
        raise ValueError(f"unknown adversary_disturbance {cfg.adversary_disturbance!r}")
    use_gnd = cfg.physics in ("pyb_gnd", "pyb_gnd_drag_dw")
    use_drag = cfg.physics in ("pyb_drag", "pyb_gnd_drag_dw")
    device = resolve_device(device)
    dtype = cfg.dtype
    quad_type = QuadType(int(cfg.quad_type))
    task = Task(cfg.task)
    cost = Cost(cfg.cost)
    n_sub = bm.check_timing(cfg.pyb_freq, cfg.ctrl_freq)
    ctrl_dt = 1.0 / cfg.ctrl_freq
    pyb_dt = 1.0 / cfg.pyb_freq
    max_steps = int(cfg.episode_len_sec * cfg.ctrl_freq)
    task_info = {**_DEFAULT_TASK_INFO, **(cfg.task_info or {})}
    nx, nu = TYPE_NX_NU[quad_type]
    labels = TYPE_INIT_LABELS[quad_type]
    three_d = quad_type == QuadType.THREE_D

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    # Nominal inertial properties with optional override (quadrotor.py:241-256).
    nom_mass, nom_j = MASS, np.array(J_DIAG)
    ip = cfg.inertial_prop
    if ip is not None:
        if isinstance(ip, dict):
            nom_mass = float(ip.get("M", ip.get("mass", nom_mass)))
            nom_j[0] = float(ip.get("Ixx", ip.get("ixx", nom_j[0])))
            nom_j[1] = float(ip.get("Iyy", ip.get("iyy", nom_j[1])))
            nom_j[2] = float(ip.get("Izz", ip.get("izz", nom_j[2])))
        else:
            arr = np.asarray(ip, float)
            if quad_type == QuadType.ONE_D:
                nom_mass = float(arr[0])
            elif quad_type == QuadType.TWO_D:
                nom_mass, nom_j[1] = float(arr[0]), float(arr[1])
            else:
                nom_mass, nom_j[0], nom_j[1], nom_j[2] = map(float, arr)

    # Spaces (quadrotor.py:699-806).
    x_thr, y_thr, z_thr = 5.0, 5.0, 2.5
    phi_thr = theta_thr = 85 * math.pi / 180
    psi_thr = math.pi
    if quad_type == QuadType.ONE_D:
        s_low, s_high = np.array([GROUND_PLANE_Z, -BIG]), np.array([z_thr, BIG])
    elif quad_type == QuadType.TWO_D:
        s_low = np.array([-x_thr, -BIG, GROUND_PLANE_Z, -BIG, -theta_thr, -BIG])
        s_high = np.array([x_thr, BIG, z_thr, BIG, theta_thr, BIG])
    else:
        s_low = np.array([-x_thr, -BIG, -y_thr, -BIG, GROUND_PLANE_Z, -BIG,
                          -phi_thr, -theta_thr, -psi_thr, -BIG, -BIG, -BIG])
        s_high = np.array([x_thr, BIG, y_thr, BIG, z_thr, BIG,
                           phi_thr, theta_thr, psi_thr, BIG, BIG, BIG])
    hover_thrust = GRAVITY_ACC * nom_mass / nu
    n_motor = 4 // nu
    if cfg.normalized_rl_action_space:
        a_low, a_high = -np.ones(nu), np.ones(nu)
    else:
        a_low = np.full(nu, KF * (4 / nu) * (PWM2RPM_SCALE * MIN_PWM + PWM2RPM_CONST) ** 2)
        a_high = np.full(nu, KF * (4 / nu) * (PWM2RPM_SCALE * MAX_PWM + PWM2RPM_CONST) ** 2)

    # Goal references (quadrotor.py:261-329).
    u_goal = np.ones(nu) * nom_mass * GRAVITY_ACC / nu
    if task == Task.STABILIZATION:
        sg = task_info["stabilization_goal"]
        if quad_type == QuadType.ONE_D:
            x_goal = np.array([sg[1], 0.0])
        elif quad_type == QuadType.TWO_D:
            x_goal = np.array([sg[0], 0.0, sg[1], 0.0, 0.0, 0.0])
        else:
            # A 2-element goal [x, z] (the reference class default) lifts to (x, 0, z).
            sg3 = list(sg) if len(sg) >= 3 else [sg[0], 0.0, sg[-1]]
            x_goal = np.hstack([sg3[0], 0.0, sg3[1], 0.0, sg3[2], 0.0, np.zeros(6)])
    else:
        pos, vel, _ = bm.generate_trajectory(
            traj_type=task_info["trajectory_type"],
            traj_length=cfg.episode_len_sec,
            num_cycles=task_info["num_cycles"],
            traj_plane=task_info["trajectory_plane"],
            position_offset=task_info["trajectory_position_offset"],
            scaling=task_info["trajectory_scale"],
            sample_time=ctrl_dt,
        )
        z = np.zeros(pos.shape[0])
        if quad_type == QuadType.ONE_D:
            x_goal = np.stack([pos[:, 2], vel[:, 2]], -1)
        elif quad_type == QuadType.TWO_D:
            x_goal = np.stack([pos[:, 0], vel[:, 0], pos[:, 2], vel[:, 2], z, z], -1)
        else:
            # The planar samples are rounded to float32 before the projection,
            # as the JAX package's table is.
            pos_t, vel_t = transform_trajectory(
                pos.astype(np.float32), vel.astype(np.float32),
                task_info["proj_point"], task_info["proj_normal"])
            x_goal = np.stack([pos_t[:, 0], vel_t[:, 0], pos_t[:, 1], vel_t[:, 1],
                               pos_t[:, 2], vel_t[:, 2], z, z, z, z, z, z], -1)

    mul = 1
    if cost == Cost.RL_REWARD and cfg.obs_goal_horizon > 0:
        mul = (1 + cfg.obs_goal_horizon) if task == Task.TRAJ_TRACKING else 2
    spaces = EnvSpaces(
        state_low=s_low, state_high=s_high, action_low=a_low, action_high=a_high,
        obs_low=np.concatenate([s_low] * mul), obs_high=np.concatenate([s_high] * mul),
    )

    constraints = build_constraints(cfg.constraints, spaces, device, dtype)
    dist_specs = cfg.disturbances or {}
    dyn_dim = int(quad_type)  # DISTURBANCE_MODES dims (quadrotor.py:808-813)
    dist_progs = {
        ch: build_disturbances(dist_specs.get(ch), dim, cfg.episode_len_sec, cfg.ctrl_freq,
                               channel=ch, pyb_freq=cfg.pyb_freq)
        for ch, dim in zip(_CHANNELS, (nx, nu, dyn_dim))
    }
    walk_dims = {ch: p.walk_dim if p is not None else 0 for ch, p in dist_progs.items()}

    # Randomization infos replace the defaults when given; the defaults are
    # filtered to this quad type's fields (quadrotor.py:485-496).
    init_rand = {k: v for k, v in _DEFAULT_INIT_RAND.items() if k in labels}
    if cfg.init_state_randomization_info is not None:
        init_rand = dict(cfg.init_state_randomization_info)
    inertial_rand = {k: v for k, v in _DEFAULT_INERTIAL_RAND.items()
                     if k in _TYPE_INERTIAL_KEYS[quad_type]}
    if cfg.inertial_prop_randomization_info is not None:
        inertial_rand = dict(cfg.inertial_prop_randomization_info)
    init_state = cfg.init_state
    if init_state is None:
        init_state = {}
    elif isinstance(init_state, (list, tuple, np.ndarray)):
        init_state = dict(zip(labels, np.asarray(init_state)))

    rew_state_w = dev(_weights_vec(cfg.rew_state_weight, nx))
    rew_act_w = dev(_weights_vec(cfg.rew_act_weight, nu))
    mse_w_np = (cfg.info_mse_metric_state_weight
                if cfg.info_mse_metric_state_weight is not None else _TYPE_MSE_W[quad_type])
    mse_w = dev(_weights_vec(mse_w_np, nx))
    Q = dev(np.diag(_weights_vec(cfg.q_weight, nx)) if cfg.q_weight is not None else np.eye(nx))
    R = dev(np.diag(_weights_vec(cfg.r_weight, nu)) if cfg.r_weight is not None else np.eye(nu))
    x_goal_t = dev(np.asarray(x_goal, np.float32))
    u_goal_t = dev(np.asarray(u_goal, np.float32))
    a_low_t, a_high_t = dev(a_low), dev(a_high)
    s_low_t, s_high_t = dev(s_low), dev(s_high)
    oob_mask_t = dev(TYPE_OOB_MASK[quad_type], torch.bool)
    goal_tol = float(task_info["stabilization_goal_tolerance"])
    if task == Task.STABILIZATION:
        goal_xyz = x_goal_t[[0, 2, 4]] if three_d else None
    else:
        goal_xyz = x_goal_t[0, [0, 2, 4]] if three_d else None

    # Competition maze: nominal poses (quadrotor.py:505-512).
    gates_nom, obstacles_nom = maze_nominal(cfg)
    NG, NO = gates_nom.shape[0], obstacles_nom.shape[0]
    gate_types = gates_nom[:, 6].astype(int)
    gate_types_t = dev(gate_types, torch.int32)
    g_xy_nom = dev(gates_nom[:, :2])
    g_yaw_nom = dev(gates_nom[:, 5])
    g_h_nom = dev(np.array([gate_geom.GATE_HEIGHTS[t] for t in gate_types], float))
    o_xy_nom = dev(obstacles_nom[:, :2])
    gates_pose_nom = dev(gates_nom[:, :6])
    go_rand = cfg.gates_and_obstacles_randomization_info or {}
    g_rand = go_rand.get("gates", {"low": -0.15, "high": 0.15})
    o_rand = go_rand.get("obstacles", {"low": -0.15, "high": 0.15})

    def _goal_rows(steps):
        """Trajectory reference row(s) for step indices (clipped gather)."""
        return x_goal_t[torch.clamp(steps.long(), 0, x_goal_t.shape[0] - 1)]

    def _extend_obs(obs, next_step):
        if mul == 1:
            return obs
        if task == Task.TRAJ_TRACKING:
            idx = next_step[:, None] + torch.arange(
                cfg.obs_goal_horizon, device=device, dtype=next_step.dtype)
            return torch.cat([obs, _goal_rows(idx).reshape(obs.shape[0], -1)], -1)
        return torch.cat([obs, x_goal_t.reshape(1, -1).expand(obs.shape[0], -1)], -1)

    def _obs(state: QuadState):
        obs = state.x
        prog = dist_progs["observation"]
        if prog is not None:
            obs = prog.apply(state.dist_offsets["observation"], state.ctrl_step, obs,
                             (state.env_seed, state.episode_idx), state.pyb_step, state.x,
                             state.dist_walk["observation"])
        return _extend_obs(obs, state.ctrl_step + 1)

    def _pos3d(x):
        """World position of the drone for any quad type."""
        if quad_type == QuadType.ONE_D:
            return torch.stack([torch.zeros_like(x[:, 0]), torch.zeros_like(x[:, 0]), x[:, 0]], -1)
        if quad_type == QuadType.TWO_D:
            return torch.stack([x[:, 0], torch.zeros_like(x[:, 0]), x[:, 2]], -1)
        return x[:, [0, 2, 4]]

    # Consolidated reset randomization: one counter draw covers inertia (4)
    # and initial state (nx), with precomputed affine bounds.  Host float32
    # arithmetic for nominal+low and high-low, as the JAX package does.
    names = ["M", "Ixx", "Iyy", "Izz"] + list(labels)
    infos = ([inertial_rand if cfg.randomized_inertial_prop else {}] * 4
             + [init_rand if cfg.randomized_init else {}] * nx)
    rand_lo = np.asarray([float(i[n]["low"]) if n in i else 0.0
                          for n, i in zip(names, infos)], np.float32)
    rand_hi = np.asarray([float(i[n]["high"]) if n in i else 0.0
                          for n, i in zip(names, infos)], np.float32)
    nominal = np.asarray([nom_mass, *nom_j] + [float(init_state.get(n, 0.0))
                                               for n in labels], np.float32)
    rand_a = dev(nominal + rand_lo)
    rand_b = dev(rand_hi - rand_lo)
    m0 = 4 + nx + 1
    n_maze = m0 + 3 * NG + 2 * NO  # the offsets' slots after the maze's
    n_slots = n_maze + num_offset_slots(dist_progs)

    def _maze_poses(u_all, B):
        """Per-env gate (x, y, yaw, height) and obstacle (x, y) poses: the
        nominal ones, or with ``randomized_gates_and_obstacles`` the nominal
        plus ``low + u * (high - low)`` from slots m0.. (3 a gate, 2 an
        obstacle), float32 sums as in quadrotor.py:680-698."""
        g_xy, g_yaw = g_xy_nom.expand(B, NG, 2), g_yaw_nom.expand(B, NG)
        o_xy = o_xy_nom.expand(B, NO, 2)
        if cfg.randomized_gates_and_obstacles:
            if NG:
                ug = u_all[m0:m0 + 3 * NG].T.reshape(B, NG, 3)
                glo, ghi = float(g_rand["low"]), float(g_rand["high"])
                g_xy = g_xy + glo + ug[..., :2] * (ghi - glo)
                g_yaw = g_yaw + glo + ug[..., 2] * (ghi - glo)
            if NO:
                uo = u_all[m0 + 3 * NG:n_maze].T.reshape(B, NO, 2)
                olo, ohi = float(o_rand["low"]), float(o_rand["high"])
                o_xy = o_xy + olo + uo * (ohi - olo)
        gates_eff = torch.cat([g_xy, g_yaw[..., None], g_h_nom.expand(B, NG)[..., None]], -1)
        return gates_eff.contiguous(), o_xy.contiguous()

    def _reset_core(env_seed, episode_idx):
        """Counter-based reset draws: slots 0..3 inertia, 4..4+nx-1 initial
        state, 4+nx a single dynamics offset, then 3 per gate (x, y, yaw) and
        2 per obstacle (x, y) (quadrotor.py:660-744), then any other
        randomized offsets (``disturbances.scheduled_offsets``)."""
        B = env_seed.shape[0]
        base = ctr_prng.episode_base(env_seed, episode_idx)
        u_all = ctr_prng.uniform_slots(base, n_slots).to(dtype)  # (n_slots, B)
        drawn = rand_a + u_all[: 4 + nx].T * rand_b
        gates_eff, obstacles_eff = _maze_poses(u_all, B)
        offsets = scheduled_offsets(dist_progs, u_all, n_maze, 4 + nx, max_steps)
        zi = torch.zeros(B, dtype=torch.int32, device=device)
        zb = torch.zeros(B, dtype=torch.bool, device=device)
        state = QuadState(
            x=drawn[:, 4:].contiguous(),
            ctrl_step=zi,
            pyb_step=zi,
            env_seed=env_seed,
            episode_idx=episode_idx.to(torch.int32),
            mass=drawn[:, 0].contiguous(),
            j_diag=drawn[:, 1:4].contiguous(),
            dist_offsets=offsets,
            dist_walk={ch: torch.zeros((B, n), dtype=dtype, device=device)
                       for ch, n in walk_dims.items()},
            cnstr_violation=zb,
            adv_force=torch.zeros((B, 3), dtype=dtype, device=device),
            adv_act=torch.zeros((B, nu), dtype=dtype, device=device),
            gates_eff=gates_eff,
            obstacles_eff=obstacles_eff,
            current_gate=zi,
            stepped_through_gate=zb,
            currently_collided=zb,
            at_goal_pos=zb,
            steps_at_goal=zi,
            task_completed=zb,
        )
        info = {}
        if constraints is not None:
            info["constraint_values_state"] = constraints.get_state_values(state.x)
        return state, _obs(state), info

    def reset(env_seeds):
        """Fresh batch: episode 0 of each env seed (int32, shape (B,))."""
        env_seeds = torch.as_tensor(env_seeds, device=device).to(torch.int32)
        return _reset_core(env_seeds, torch.zeros_like(env_seeds))

    def reset_episode(state: QuadState):
        """Next episode of the same envs (the auto-reset path)."""
        return _reset_core(state.env_seed, state.episode_idx + 1)

    drag_coeff = torch.tensor(DRAG_COEFF, dtype=dtype, device=device)

    def _aero(x, forces, ext_f3):
        """Ground effect and drag (base_aviary.py:437-496; quadrotor.py:597-630):
        the ground effect adds per-motor thrust by the CoM height, the drag a
        body-frame force proportional to the body-frame velocity and the
        propellers' total speed."""
        zero = torch.zeros_like(x[:, 0])
        if quad_type == QuadType.ONE_D:
            z, vel = x[:, 0], torch.stack([zero, zero, x[:, 1]], -1)
            phi = theta = zero
            rob = torch.eye(3, dtype=x.dtype, device=x.device).expand(x.shape[0], 3, 3)
        elif quad_type == QuadType.TWO_D:
            z, vel = x[:, 2], torch.stack([x[:, 1], zero, x[:, 3]], -1)
            phi, theta = zero, x[:, 4]
            rob = rot_xyz(zero, theta, zero)
        else:
            z, vel = x[:, 4], torch.stack([x[:, 1], x[:, 3], x[:, 5]], -1)
            phi, theta = x[:, 6], x[:, 7]
            rob = rot_xyz(phi, theta, x[:, 8])
        if use_gnd:
            h = torch.clamp_min(z, GND_EFF_H_CLIP)
            ge = forces * GND_EFF_COEFF * ((PROP_RADIUS / (4 * h)) ** 2)[:, None]
            upright = (phi.abs() < math.pi / 2) & (theta.abs() < math.pi / 2)
            forces = forces + torch.where(upright[:, None], ge, torch.zeros_like(ge))
        if use_drag:
            rpm_sum = (2 * math.pi * torch.sqrt(div(forces, KF)) / 60).sum(-1)
            drag_body = -drag_coeff * rpm_sum[:, None] * torch.einsum("bji,bj->bi", rob, vel)
            ext_f3 = ext_f3 + torch.einsum("bij,bj->bi", rob, drag_body)
        return forces, ext_f3

    def _fc(x, forces, mass, j_diag, ext_f3):
        """x' of the body of this quad type (quadrotor.py:585-595), with the
        aero terms where the physics mode has them."""
        if use_gnd or use_drag:
            forces, ext_f3 = _aero(x, forces, ext_f3)
        if quad_type == QuadType.ONE_D:
            return quad_fc_1d(x, forces, mass, ext_f3[:, 2])
        if quad_type == QuadType.TWO_D:
            return quad_fc_2d(x, forces, mass, j_diag[:, 1], ext_f3[:, 0], ext_f3[:, 2])
        return quad_fc_3d(x, forces, mass, j_diag, ext_f3)

    def _plain_substeps(x, thrust, ext_f3, mass, j_diag):
        """The actuation and the physics substeps in plain PyTorch
        (quadrotor.py:834-865): the 1D and 2D bodies, and the 3D body in the
        ground-effect and drag modes."""
        forces = actuate(thrust) if three_d else planar_forces(thrust, n_motor)
        fc = lambda xx, f: _fc(xx, f, mass, j_diag, ext_f3)  # noqa: E731
        for _ in range(n_sub):
            x = x + pyb_dt * fc(x, forces) if cfg.physics == "dyn" else rk4_step(fc, x, forces, pyb_dt)
        return x

    def set_adversary_control(state: QuadState, adv_action):
        """The adversary's action for the next step (benchmark_env.py:256-266):
        clipped to [-1, 1], scaled and offset, as an action offset (B, nu)
        or a world force (B, 3: the 1D quad's on z, the 2D quad's on x and
        z)."""
        adv = torch.clamp(torch.as_tensor(adv_action, dtype=dtype, device=device), -1.0, 1.0)
        adv = adv * cfg.adversary_disturbance_scale + cfg.adversary_disturbance_offset
        adv = adv.reshape(state.x.shape[0], -1)
        if cfg.adversary_disturbance == "action":
            return state.replace(adv_act=adv.reshape(-1, nu))
        if cfg.adversary_disturbance == "dynamics":
            zero = torch.zeros_like(adv[:, 0])
            if quad_type == QuadType.ONE_D:
                f = torch.stack([zero, zero, adv[:, 0]], -1)
            elif quad_type == QuadType.TWO_D:
                f = torch.stack([adv[:, 0], zero, adv[:, 1]], -1)
            else:
                f = adv.reshape(-1, 3)
            return state.replace(adv_force=f)
        raise RuntimeError("adversary_disturbance is not configured for this env.")

    def step(state: QuadState, action):
        B = state.x.shape[0]
        identity = (state.env_seed, state.episode_idx)
        action = torch.as_tensor(action, dtype=dtype, device=device).reshape(B, nu)
        # Preprocess (quadrotor.py:815-842).
        if cfg.normalized_rl_action_space:
            clipped = torch.clamp(action, -1.0, 1.0)
            thrust = (1.0 + cfg.norm_act_scale * clipped) * hover_thrust
        else:
            thrust = torch.clamp(action, a_low_t, a_high_t)
        preprocessed = thrust
        if dist_progs["action"] is not None:
            thrust = dist_progs["action"].apply(
                state.dist_offsets["action"], state.ctrl_step, thrust, identity, state.pyb_step,
                state.x, state.dist_walk["action"])
        if cfg.adversary_disturbance == "action":
            thrust = thrust + state.adv_act
        ext = torch.zeros((B, dyn_dim), dtype=dtype, device=device)
        if dist_progs["dynamics"] is not None:
            ext = dist_progs["dynamics"].apply(
                state.dist_offsets["dynamics"], state.ctrl_step, ext, identity, state.pyb_step,
                state.x, state.dist_walk["dynamics"])
        # The world force (quadrotor.py:880-887): the 1D quad's on z, the 2D
        # quad's on x and z.
        zero = torch.zeros_like(ext[:, 0])
        ext_f3 = (torch.stack([zero, zero, ext[:, 0]], -1) if quad_type == QuadType.ONE_D
                  else torch.stack([ext[:, 0], zero, ext[:, 1]], -1)
                  if quad_type == QuadType.TWO_D else ext)
        if cfg.adversary_disturbance == "dynamics":
            ext_f3 = ext_f3 + state.adv_force
        if three_d and not (use_gnd or use_drag):
            # K1: actuation pipeline and all physics substeps in one launch.
            x = quad3d_substeps(
                state.x, thrust.contiguous(), ext_f3.contiguous(), state.mass, state.j_diag,
                dt=pyb_dt, n_sub=n_sub, euler=(cfg.physics == "dyn"), actuation=True)
        else:
            x = _plain_substeps(state.x, thrust, ext_f3, state.mass, state.j_diag)
        # The brownian walks one step on (quadrotor.py:912-918).
        walk = {ch: prog.evolve(state.dist_walk[ch], state.ctrl_step, identity)
                if prog is not None else state.dist_walk[ch] for ch, prog in dist_progs.items()}

        # Competition info: collision, gate progress (quadrotor.py:884-962).
        info = {}
        pos = _pos3d(x)
        ge, oe = state.gates_eff, state.obstacles_eff
        collided = gate_geom.ground_collision(pos)
        if NG:
            collided = collided | gate_geom.gate_collision(
                pos, ge[..., :2], ge[..., 2], ge[..., 3]).any(-1)
        if NO:
            collided = collided | gate_geom.obstacle_collision(pos, oe).any(-1)
        info["collision"] = collided
        stepped = torch.zeros(B, dtype=torch.bool, device=device)
        new_gate = state.current_gate
        if NG:
            # Gate progress after the settling window (quadrotor.py:1060).
            active = (state.pyb_step > 0.5 * cfg.pyb_freq) & (state.current_gate < NG)
            hits = gate_geom.gate_pass_hit(pos, ge[..., :2], ge[..., 2], ge[..., 3])
            cur = torch.clamp(state.current_gate, 0, NG - 1).long()[:, None]
            stepped = active & hits.gather(-1, cur)[:, 0]
            new_gate = state.current_gate + stepped.to(torch.int32)
            in_range = gate_geom.gate_in_range(pos, ge[..., :2], ge[..., 3])
            cg = torch.clamp(new_gate, 0, NG - 1).long()
            has_gate = new_gate < NG
            rows = torch.arange(B, device=device)
            info["current_target_gate_id"] = torch.where(has_gate, new_gate,
                                                         torch.full_like(new_gate, -1))
            info["current_target_gate_in_range"] = has_gate & in_range[rows, cg]
            # [x, y, z, r, p, yaw]: effective when in range, nominal otherwise.
            eff = ge[rows, cg]
            zero = torch.zeros_like(eff[:, 0])
            eff_pose = torch.stack([eff[:, 0], eff[:, 1], eff[:, 3], zero, zero, eff[:, 2]], -1)
            info["current_target_gate_pos"] = torch.where(
                info["current_target_gate_in_range"][:, None], eff_pose, gates_pose_nom[cg])
            info["current_target_gate_type"] = torch.where(
                has_gate, gate_types_t[cg], torch.full_like(new_gate, -1))
        else:
            full = torch.full((B,), -1, dtype=torch.int32, device=device)
            info["current_target_gate_id"] = full
            info["current_target_gate_in_range"] = torch.zeros(B, dtype=torch.bool, device=device)
            info["current_target_gate_pos"] = torch.zeros((B, 6), dtype=dtype, device=device)
            info["current_target_gate_type"] = full
        # At-goal / task completion (quadrotor.py:1114-1133), 3D only.
        if three_d:
            at_goal = (new_gate >= NG) & (torch.linalg.norm(pos - goal_xyz, dim=-1) < goal_tol)
            steps_at_goal = torch.where(at_goal, state.steps_at_goal + 1,
                                        torch.zeros_like(state.steps_at_goal))
            completed = state.task_completed | (steps_at_goal > cfg.ctrl_freq * 2)
        else:
            at_goal = torch.zeros(B, dtype=torch.bool, device=device)
            steps_at_goal, completed = state.steps_at_goal, state.task_completed
        info["at_goal_position"] = at_goal
        info["task_completed"] = completed

        # Done (quadrotor.py:956-1002).
        done = torch.zeros(B, dtype=torch.bool, device=device)
        goal = x_goal_t if task == Task.STABILIZATION else _goal_rows(state.ctrl_step)
        if task == Task.STABILIZATION and cost == Cost.QUADRATIC:
            goal_reached = torch.linalg.norm(x - goal, dim=-1) < goal_tol
            done = done | goal_reached
            info["goal_reached"] = goal_reached
        if cfg.done_on_out_of_bound:
            oob = (x < s_low_t) | (x > s_high_t)
            done = done | (oob & oob_mask_t).any(-1)
        if cfg.done_on_collision:
            done = done | collided
        if cfg.done_on_completion:
            done = done | completed

        # Reward (quadrotor.py:886-954).
        act_err = preprocessed - u_goal_t
        if cost == Cost.RL_REWARD:
            state_err = x - goal
            dist = (rew_state_w * state_err * state_err).sum(-1) + (
                rew_act_w * act_err * act_err).sum(-1)
            rew = torch.exp(-dist) if cfg.rew_exponential else -dist
        elif cost == Cost.QUADRATIC:
            dx = x - goal
            rew = -(((0.5 * dx) @ Q * dx).sum(-1) + ((0.5 * act_err) @ R * act_err).sum(-1))
        else:
            # Competition (quadrotor.py:990-1001): the violation term reads
            # the previous step's flag, as the reference's order does.
            rew = (100.0 * stepped.to(dtype) + 100.0 * at_goal.to(dtype)
                   - 1000.0 * collided.to(dtype) - 100.0 * state.cnstr_violation.to(dtype))

        err = (x - goal) * mse_w
        info["mse"] = (err * err).sum(-1)

        # after_step (benchmark_env.py:422-463).
        violated = state.cnstr_violation
        if constraints is not None:
            c_val = constraints.get_values(x, action)
            violated = constraints.is_violated(c_val)
            info["constraint_values"] = c_val
            info["constraint_violation"] = violated.to(torch.int32)
            if cfg.done_on_violation:
                done = done | violated
            if cost == Cost.RL_REWARD and cfg.use_constraint_penalty:
                rew = torch.where(constraints.is_almost_active(c_val),
                                  rew + cfg.constraint_penalty, rew)
        # Non-finite safety net: freeze the last finite state, end the
        # episode and zero the reward (quadrotor.py:1020-1032).
        finite = torch.isfinite(x).all(-1)
        x = torch.where(finite[:, None], x, state.x)
        done = done | ~finite
        rew = torch.where(finite, rew, torch.zeros_like(rew))

        new_ctrl = state.ctrl_step + 1
        timeout = new_ctrl >= max_steps
        info["TimeLimit.truncated"] = timeout & ~done
        done = done | timeout
        new_state = state.replace(
            x=x,
            ctrl_step=new_ctrl,
            pyb_step=state.pyb_step + n_sub,
            dist_walk=walk,
            cnstr_violation=violated,
            adv_force=torch.zeros_like(state.adv_force),
            adv_act=torch.zeros_like(state.adv_act),
            current_gate=new_gate,
            stepped_through_gate=stepped,
            currently_collided=collided,
            at_goal_pos=at_goal,
            steps_at_goal=steps_at_goal,
            task_completed=completed,
        )
        return new_state, _obs(new_state), rew.to(dtype), done, info

    if quad_type == QuadType.THREE_D:
        # The 3D model's nominal parameters for each float type, on the
        # env's device, made once: evaluating the model copies nothing to the
        # device (an MPC solve evaluates it thousands of times).
        nominal_3d = {fdt: (torch.tensor(nom_mass, dtype=fdt, device=device),
                            torch.tensor(nom_j, dtype=fdt, device=device),
                            torch.zeros(3, dtype=fdt, device=device))
                      for fdt in (torch.float32, torch.float64)}

    def symbolic_fc(x_s, u_s):
        """The a-priori model on nominal parameters (quadrotor.py:1047-1070):
        one state, the commanded thrusts as input (not motor forces)."""
        zero = torch.zeros_like(u_s[..., 0])
        if quad_type == QuadType.ONE_D:  # U = the total thrust
            return quad_fc_1d(x_s, torch.stack([u_s[..., 0], zero, zero, zero], -1), nom_mass,
                              zero)
        if quad_type == QuadType.TWO_D:
            # U = the paired thrusts (T1, T2) on motors (T1, T2, 0, 0), so
            # that T1 = f0 + f3 and T2 = f1 + f2 reduce to them.
            return quad_fc_2d(x_s, torch.stack([u_s[..., 0], u_s[..., 1], zero, zero], -1),
                              nom_mass, float(nom_j[1]), zero, zero)
        return quad_fc_3d(x_s, u_s, *nominal_3d[x_s.dtype])

    return FnEnv(
        reset=reset,
        step=step,
        spaces=spaces,
        symbolic=DynamicsModel(fc_func=symbolic_fc, nx=nx, nu=nu, dt=ctrl_dt),
        config=cfg,
        x_goal=x_goal,
        u_goal=u_goal,
        ctrl_freq=cfg.ctrl_freq,
        pyb_freq=cfg.pyb_freq,
        episode_len_sec=cfg.episode_len_sec,
        device=device,
        extras={"set_adversary_control": set_adversary_control,
                "reset_episode": reset_episode},
    )
