"""DSL Crazyflie two-stage PID controller.

Port of ``safe_control_gym_tpu/controllers/pid.py`` (reference
safe_control_gym/controllers/pid/pid.py and ``PIDController`` in
envs/gym_pybullet_drones/quadrotor_utils.py:70-278): a position PID gives
the target thrust and attitude, an attitude PID the per-motor RPM through
the mixer matrix.  :func:`pid_control` works over leading batch dims (the
JAX package runs it under ``vmap``), with its state (integrals, last
attitude) in an explicit :class:`PIDState`, so a batch of drones steps in
lockstep; :class:`PID` keeps the JAX package's one-env host controller.

Angles follow the engine's SDFormat extrinsic-XYZ Euler state.  Divisions by
a constant go through ``ops/quad_substeps.py::div`` (a true division on
every device).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from safe_control_gym_torch.controllers.base import BaseController
from safe_control_gym_torch.envs.benchmark import Task
from safe_control_gym_torch.envs.quadrotor import MASS, QuadType
from safe_control_gym_torch.ops.quad_substeps import GRAVITY as GRAVITY_ACC
from safe_control_gym_torch.ops.quad_substeps import (KF, MAX_PWM, MIN_PWM, PWM2RPM_CONST,
                                                      PWM2RPM_SCALE, div)
from safe_control_gym_torch.ops.rotations import rot_xyz

# Default gains (quadrotor_utils.py:84-89).
P_FOR = (0.4, 0.4, 1.25)
I_FOR = (0.05, 0.05, 0.05)
D_FOR = (0.2, 0.2, 0.5)
P_TOR = (70000.0, 70000.0, 60000.0)
I_TOR = (0.0, 0.0, 500.0)
D_TOR = (20000.0, 20000.0, 12000.0)
MIXER = ((0.5, -0.5, 1.0), (0.5, 0.5, -1.0), (-0.5, 0.5, 1.0), (-0.5, -0.5, -1.0))


@dataclasses.dataclass
class PIDState:
    """Integrators and the last attitude (quadrotor_utils.py:126-137), each
    (..., 3)."""

    integral_pos_e: torch.Tensor
    integral_rpy_e: torch.Tensor
    last_rpy: torch.Tensor

    @classmethod
    def create(cls, batch_shape=(), dtype=torch.float32, device=None):
        z = torch.zeros(*batch_shape, 3, dtype=dtype, device=device)
        return cls(z, z, z)


def _mat_to_euler_xyz(R):
    """Extrinsic-XYZ Euler angles (..., 3) of R = Rz(psi) Ry(theta) Rx(phi)."""
    theta = torch.arcsin(-R[..., 2, 0])
    phi = torch.arctan2(R[..., 2, 1], R[..., 2, 2])
    psi = torch.arctan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([phi, theta, psi], -1)


def pid_control(state: PIDState, dt, cur_pos, cur_rpy, cur_vel, target_pos, target_rpy=None,
                target_vel=None, target_rpy_rates=None, g: float = GRAVITY_ACC,
                mass: float = MASS):
    """One PID step over leading batch dims -> (rpm (..., 4), new state,
    position error (..., 3), yaw error (...)).

    Mirrors PIDController.compute_control / _compute_force_and_euler /
    _compute_rpms (quadrotor_utils.py:139-278).  Targets broadcast against
    the current state."""
    like = dict(dtype=cur_pos.dtype, device=cur_pos.device)
    zero3 = torch.zeros(3, **like)
    target_rpy = zero3 if target_rpy is None else target_rpy
    target_vel = zero3 if target_vel is None else target_vel
    target_rpy_rates = zero3 if target_rpy_rates is None else target_rpy_rates
    const = lambda v: torch.tensor(v, **like)  # noqa: E731

    R = rot_xyz(cur_rpy[..., 0], cur_rpy[..., 1], cur_rpy[..., 2])
    pos_e = target_pos - cur_pos
    vel_e = target_vel - cur_vel
    ipe = torch.clamp(state.integral_pos_e + pos_e * dt, -2.0, 2.0)
    ipe = torch.cat([ipe[..., :2], torch.clamp(ipe[..., 2:], -0.15, 0.15)], -1)
    target_thrust = (const(P_FOR) * pos_e + const(I_FOR) * ipe + const(D_FOR) * vel_e
                     + const((0.0, 0.0, g * mass)))
    scalar_thrust = torch.clamp_min((target_thrust * R[..., :, 2]).sum(-1), 0.0)
    thrust_pwm = div(torch.sqrt(div(scalar_thrust, 4 * KF)) - PWM2RPM_CONST, PWM2RPM_SCALE)
    # The desired attitude from the thrust direction and the commanded yaw
    # (quadrotor_utils.py:228-234).
    target_z = target_thrust / torch.linalg.vector_norm(target_thrust, dim=-1, keepdim=True)
    yaw = torch.broadcast_to(target_rpy[..., 2], target_z.shape[:-1])
    target_xc = torch.stack([torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw)], -1)
    yc = torch.linalg.cross(target_z, target_xc)
    target_y = yc / torch.linalg.vector_norm(yc, dim=-1, keepdim=True)
    target_x = torch.linalg.cross(target_y, target_z)
    target_euler = _mat_to_euler_xyz(torch.stack([target_x, target_y, target_z], -1))

    # Attitude PID (quadrotor_utils.py:239-278).
    Rd = rot_xyz(target_euler[..., 0], target_euler[..., 1], target_euler[..., 2])
    rot_e_m = Rd.mT @ R - R.mT @ Rd
    rot_e = torch.stack([rot_e_m[..., 2, 1], rot_e_m[..., 0, 2], rot_e_m[..., 1, 0]], -1)
    rpy_rates_e = target_rpy_rates - div(cur_rpy - state.last_rpy, dt)
    ire = torch.clamp(state.integral_rpy_e - rot_e * dt, -1500.0, 1500.0)
    ire = torch.cat([torch.clamp(ire[..., :2], -1.0, 1.0), ire[..., 2:]], -1)
    torques = -const(P_TOR) * rot_e + const(D_TOR) * rpy_rates_e + const(I_TOR) * ire
    torques = torch.clamp(torques, -3200.0, 3200.0)
    pwm = torch.clamp(thrust_pwm[..., None] + torques @ const(MIXER).mT, MIN_PWM, MAX_PWM)
    rpm = PWM2RPM_SCALE * pwm + PWM2RPM_CONST
    return (rpm, PIDState(ipe, ire, cur_rpy), pos_e,
            target_euler[..., 2] - cur_rpy[..., 2])


class PID(BaseController):
    """Evaluation controller for the quadrotor env (reference pid.py:65-152
    runs it on the 2D quad with paired motor forces).  ``select_action``
    steps one env on the host; :meth:`act` is the same over a batch."""

    def __init__(self, env, **kwargs):
        super().__init__(env, **kwargs)
        self.quad_type = QuadType(int(env.config.quad_type))
        self.task = Task(env.config.task)
        self.dt = env.ctrl_timestep
        self.x_goal = torch.as_tensor(np.asarray(env.x_goal), dtype=torch.float32,
                                      device=env.device)
        self.pid_state = PIDState.create(device=env.device)
        self._step_i = 0

    def reset(self):
        self.pid_state = PIDState.create(device=self.env.device)
        self._step_i = 0

    def _xyz(self, x, i_pos, i_vel):
        """3D position and velocity (..., 3) from the state columns of x, z
        (or z alone) and their rates; y is 0 off the 3D quad."""
        z = 0.0 * x[..., 0]
        pos = [x[..., i] if i is not None else z for i in i_pos]
        vel = [x[..., i] if i is not None else z for i in i_vel]
        return torch.stack(pos, -1), torch.stack(vel, -1)

    def _targets(self, k: int):
        """The goal position and velocity (3,) at step ``k``."""
        g = self.x_goal if self.task == Task.STABILIZATION else \
            self.x_goal[min(max(k, 0), self.x_goal.shape[0] - 1)]
        return self._unpack(g)[:2]

    def _unpack(self, x):
        """(pos, vel, rpy), each (..., 3), of states x (..., nx)."""
        if self.quad_type == QuadType.ONE_D:
            pos, vel = self._xyz(x, (None, None, 0), (None, None, 1))
            return pos, vel, torch.zeros_like(pos)
        if self.quad_type == QuadType.TWO_D:
            pos, vel = self._xyz(x, (0, None, 2), (1, None, 3))
            z = 0.0 * x[..., 4]
            return pos, vel, torch.stack([z, x[..., 4], z], -1)
        pos, vel = self._xyz(x, (0, 2, 4), (1, 3, 5))
        return pos, vel, x[..., 6:9]

    def act(self, obs, k: int, pid_state: PIDState):
        """Actions (..., nu) for states ``obs`` (..., nx) at step ``k`` and
        the new PID state: the motor forces rpm^2 KF, paired (f1 + f4,
        f2 + f3) on the 2D quad and summed on the 1D quad."""
        pos, vel, rpy = self._unpack(obs)
        t_pos, t_vel = self._targets(k)
        rpm, pid_state, _, _ = pid_control(pid_state, self.dt, pos, rpy, vel, t_pos,
                                           target_vel=t_vel)
        forces = rpm**2 * KF
        if self.quad_type == QuadType.ONE_D:
            return forces.sum(-1, keepdim=True), pid_state
        if self.quad_type == QuadType.TWO_D:
            return torch.stack([forces[..., 0] + forces[..., 3],
                                forces[..., 1] + forces[..., 2]], -1), pid_state
        return forces, pid_state

    @torch.no_grad()
    def select_action(self, obs, info=None):
        """One env's action (NumPy) for one observation (nx,)."""
        x = torch.as_tensor(np.array(obs, np.float32), device=self.env.device)
        a, self.pid_state = self.act(x, self._step_i, self.pid_state)
        self._step_i += 1
        return a.cpu().numpy()
