"""Mellinger geometric controller with Crazyflie-firmware numerics.

Port of ``safe_control_gym_tpu/controllers/mellinger.py`` (the public
Crazyflie firmware's controller_mellinger.c with its default gains, which
the reference drives through SWIG at 500 Hz, firmware_wrapper.py:446-461).
:func:`mellinger_control` works over leading batch dims, on the caller's
device and dtype, with its state (integrals, last rates) in an explicit
:class:`MellingerState`; the firmware wrapper (``controllers/firmware.py``)
runs it on a batch of one, in float32.

Structure (Mellinger & Kumar 2011):
  position PID -> desired thrust vector F_des;
  thrust = massThrust * F_des . z_body;
  desired attitude from (F_des direction, commanded yaw);
  moments = -kR eR + kw ew + ki integral(eR) + kd_omega d(ew)/dt;
  X-configuration power distribution -> 4 motor PWMs
  (firmware_wrapper.py:688-707 _powerDistribution, including the brushed
  motor thrust->PWM map at :668-677).

The per-axis gains are device tensors made once per (dtype, device)
(:func:`_gains`): a tick copies nothing from the host.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from safe_control_gym_torch.ops.quad_substeps import (KF, MIN_PWM, PWM2RPM_CONST, PWM2RPM_SCALE,
                                                      div)
from safe_control_gym_torch.ops.rotations import rot_xyz

# Firmware default gains (controller_mellinger.c).
MASS_FW = 0.032
MASS_THRUST = 132000.0
KP = (0.4, 0.4, 1.25)
KD = (0.2, 0.2, 0.4)
KI = (0.05, 0.05, 0.05)
I_RANGE = (2.0, 2.0, 0.4)
KR_XY, KW_XY = 70000.0, 20000.0
KI_M_XY, I_RANGE_M_XY = 0.0, 1.0
KR_Z, KW_Z = 60000.0, 12000.0
KI_M_Z, I_RANGE_M_Z = 500.0, 1500.0
# Stock firmware gain (controller_mellinger.c kd_omega_rp = 200), run against
# the 80 Hz-low-passed finite-difference gyro the wrapper computes — the same
# signal path the real firmware sees (firmware_wrapper.py:248-268 + lpf2p).
KD_OMEGA_RP = 200.0
GRAVITY_MAG = 9.81
THRUST_MIN, THRUST_MAX = 20000.0, 65535.0  # control thrust clamp (PWM units)
MOMENT_CLAMP = 32000.0
MAX_PWM = 65535.0
SUPPLY_VOLTAGE = 3.0


@functools.lru_cache(maxsize=None)
def _gains(dtype, device):
    """The per-axis gain vectors as tensors of ``dtype`` on ``device``."""
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    return dict(
        kp=t(KP), kd=t(KD), ki=t(KI), i_range=t(I_RANGE),
        i_range_m=t((I_RANGE_M_XY, I_RANGE_M_XY, I_RANGE_M_Z)),
        kr=t((KR_XY, KR_XY, KR_Z)), kw=t((KW_XY, KW_XY, KW_Z)),
        ki_m=t((KI_M_XY, KI_M_XY, KI_M_Z)), z3=t((0.0, 0.0, 0.0)),
    )


@dataclasses.dataclass
class MellingerState:
    """The controller's integrals and last rates, each (..., k)."""

    i_error_pos: torch.Tensor  # (..., 3)
    i_error_m: torch.Tensor  # (..., 3) attitude integral
    prev_omega_rp: torch.Tensor  # (..., 2) for the omega derivative term
    prev_setpoint_omega_rp: torch.Tensor  # (..., 2)

    @classmethod
    def create(cls, batch_shape=(), dtype=torch.float32, device=None):
        z = lambda n: torch.zeros(*batch_shape, n, dtype=dtype, device=device)  # noqa: E731
        return cls(z(3), z(3), z(2), z(2))


def mellinger_control(ms: MellingerState, dt, pos, vel, rpy, omega, sp_pos, sp_vel=None,
                      sp_acc=None, sp_yaw=0.0, sp_omega=None, mass: float = MASS_FW,
                      kd_omega_rp: float = KD_OMEGA_RP):
    """One Mellinger tick over leading batch dims -> (control dict, new
    state).  ``pos``, ``vel``, ``rpy``, ``omega`` (body rates, rad/s) and the
    setpoints are (..., 3); ``sp_yaw`` is (...) or a float.

    control: {"thrust", "roll", "pitch", "yaw"}, each (...), in firmware
    PWM-scale units, to be mixed by :func:`power_distribution`."""
    g = _gains(pos.dtype, pos.device)
    sp_vel = g["z3"] if sp_vel is None else sp_vel
    sp_acc = g["z3"] if sp_acc is None else sp_acc
    sp_omega = g["z3"] if sp_omega is None else sp_omega
    if not torch.is_tensor(sp_yaw):  # a fill, not a host-to-device copy
        sp_yaw = torch.full((), float(sp_yaw), dtype=pos.dtype, device=pos.device)

    r_error = sp_pos - pos
    v_error = sp_vel - vel
    i_error = torch.clamp(ms.i_error_pos + r_error * dt, -g["i_range"], g["i_range"])
    target_thrust = mass * sp_acc + g["kp"] * r_error + g["kd"] * v_error + g["ki"] * i_error
    target_thrust = torch.cat([target_thrust[..., :2],
                               target_thrust[..., 2:] + mass * GRAVITY_MAG], -1)

    R = rot_xyz(rpy[..., 0], rpy[..., 1], rpy[..., 2])
    current_thrust = MASS_THRUST * (target_thrust * R[..., :, 2]).sum(-1)

    z_des = target_thrust / torch.linalg.vector_norm(target_thrust, dim=-1, keepdim=True)
    yaw = torch.broadcast_to(sp_yaw, z_des.shape[:-1])
    x_c = torch.stack([torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw)], -1)
    y_des_un = torch.linalg.cross(z_des, x_c)
    y_des = y_des_un / torch.linalg.vector_norm(y_des_un, dim=-1, keepdim=True)
    x_des = torch.linalg.cross(y_des, z_des)
    Rdes = torch.stack([x_des, y_des, z_des], -1)

    eRM = 0.5 * (Rdes.mT @ R - R.mT @ Rdes)
    eR = torch.stack([eRM[..., 2, 1], eRM[..., 0, 2], eRM[..., 1, 0]], -1)
    ew = sp_omega - omega
    # d(omega)/dt damping on roll/pitch (controller_mellinger.c err_d terms).
    err_d = div((sp_omega[..., :2] - ms.prev_setpoint_omega_rp)
                - (omega[..., :2] - ms.prev_omega_rp), max(dt, 1e-6))
    i_error_m = torch.clamp(ms.i_error_m + (-eR) * dt, -g["i_range_m"], g["i_range_m"])

    # The stock kd_omega_rp = 200 is tuned against a real MEMS gyro; the
    # wrapper's finite-difference gyro makes it negative rate-loop damping,
    # and the competition stack passes 0 (competition/getting_started.py).
    # The yaw row has no derivative term (its err_d entry is 0).
    err_d3 = torch.cat([err_d, torch.zeros_like(err_d[..., :1])], -1)
    M = -g["kr"] * eR + g["kw"] * ew + g["ki_m"] * i_error_m + kd_omega_rp * err_d3

    # Sign conventions at the mixer: with the X-configuration mixing
    # (power_distribution) and the firmware->env motor remap, a positive
    # control.pitch / control.yaw produces a NEGATIVE physical body moment —
    # the firmware compensates with its legacy inverted-pitch convention
    # (controller_mellinger.c flips eR.y/gyro.y; control->yaw = -M.z).  The
    # moments above are in the consistent SDFormat convention, so pitch and
    # yaw are negated here.
    moments = torch.clamp(torch.stack([M[..., 0], -M[..., 1], -M[..., 2]], -1),
                          -MOMENT_CLAMP, MOMENT_CLAMP)
    control = {"thrust": torch.clamp(current_thrust, THRUST_MIN, THRUST_MAX),
               "roll": moments[..., 0], "pitch": moments[..., 1], "yaw": moments[..., 2]}
    new_state = MellingerState(i_error_pos=i_error, i_error_m=i_error_m,
                               prev_omega_rp=omega[..., :2],
                               prev_setpoint_omega_rp=torch.broadcast_to(
                                   sp_omega[..., :2], omega[..., :2].shape))
    return control, new_state


def _motors_get_pwm(thrust):
    """Brushed-motor thrust->PWM map (firmware_wrapper.py:668-677)."""
    t = thrust / 65536.0 * 60.0
    volts = -0.0006239 * t**2 + 0.088 * t
    return torch.clamp_max(div(volts, SUPPLY_VOLTAGE), 1.0) * MAX_PWM


def power_distribution(control):
    """X-configuration mixing -> 4 PWMs (..., 4) (firmware_wrapper.py:688-707)."""
    r = control["roll"] / 2.0
    p = control["pitch"] / 2.0
    t, y = control["thrust"], control["yaw"]
    raw = torch.stack([t - r + p + y, t - r - p - y, t + r - p + y, t + r + p - y], -1)
    return _motors_get_pwm(torch.clamp(raw, 0.0, MAX_PWM))


class MellingerController:
    """Registry-facing shell: track a position setpoint on the 3D quadrotor
    (one env), a lightweight stand-in for the full firmware emulation of
    ``controllers/firmware.py``."""

    def __init__(self, env, **kwargs):
        self.env = env
        self.dt = env.ctrl_timestep
        self.x_goal = np.asarray(env.x_goal, np.float32)
        self.reset()

    def _make_lpf(self):
        # Same gyro conditioning as the SITL wrapper: finite-difference Euler
        # rates through the reference's (swapped-cutoff) 30 Hz lpf2p — the
        # stock KD_OMEGA_RP=200 derivative term is only stable against this
        # filtered signal, not raw analytic body rates.
        from safe_control_gym_torch.controllers.firmware import FirmwareWrapper, Lpf2p

        fs = 1.0 / self.dt
        self._gyro_lpf = [Lpf2p(fs, FirmwareWrapper.ACCEL_LPF_CUTOFF_FREQ) for _ in range(3)]
        self._prev_rpy = None

    def reset(self):
        self.ms = MellingerState.create(device=self.env.device)
        self._step_i = 0
        self._make_lpf()

    @torch.no_grad()
    def select_action(self, obs, info=None):
        """The 4 motor forces (NumPy, env motor order) for one observation."""
        x = np.asarray(obs, np.float32)
        rpy_np = np.asarray(x[6:9], dtype=float)
        rates = np.zeros(3) if self._prev_rpy is None else (rpy_np - self._prev_rpy) / self.dt
        self._prev_rpy = rpy_np
        omega = np.asarray([self._gyro_lpf[i].apply(rates[i]) for i in range(3)], np.float32)
        g = self.x_goal if self.x_goal.ndim == 1 else \
            self.x_goal[min(self._step_i, self.x_goal.shape[0] - 1)]
        # One host-to-device copy: pos, vel, rpy, omega, sp_pos, sp_vel.
        rows = torch.from_numpy(np.stack([x[[0, 2, 4]], x[[1, 3, 5]], x[6:9], omega,
                                          g[[0, 2, 4]], g[[1, 3, 5]]])).to(self.env.device)
        control, self.ms = mellinger_control(self.ms, self.dt, *rows)
        rpm = PWM2RPM_SCALE * torch.clamp(power_distribution(control), MIN_PWM, MAX_PWM) \
            + PWM2RPM_CONST
        self._step_i += 1
        # Firmware motor numbering -> env motor numbering ([3, 2, 1, 0],
        # firmware_wrapper.py:277-278).
        return (KF * rpm**2).cpu().numpy()[[3, 2, 1, 0]]
