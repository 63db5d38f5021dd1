"""The 3D quadrotor: cf2x constants, PWM actuation, RK4 substeps of the
12-state rigid body, figure-8 tracking, the exponential RL reward and
out-of-bound done.  The constants are frozen copies of upstream's URDF and
YAML defaults; the arithmetic keeps the order of the upstream equations as
the program under test states them, one rounding an operation."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.envs import GRAVITY, div, rk4

FIELDS = {"quad_type", "ctrl_freq", "pyb_freq", "episode_len_sec", "task", "task_info",
          "cost", "normalized_rl_action_space", "norm_act_scale",
          "randomized_inertial_prop", "randomized_init", "rew_state_weight",
          "rew_act_weight", "rew_exponential", "done_on_out_of_bound"}
DIMS = (12, 4)
N_INERTIAL = 4  # mass and the inertia diagonal
N_SLOTS = 17

# cf2x.urdf and the Crazyflie PWM map (upstream base_aviary.py, quadrotor_utils.py).
MASS, J = 0.03454, (1.4e-5, 1.4e-5, 2.17e-5)
KF, KM, ARM_L = 3.16e-10, 7.94e-12, 0.0397
PWM2RPM_SCALE, PWM2RPM_CONST, MIN_PWM, MAX_PWM = 0.2685, 4070.3, 20000.0, 65535.0
INERTIAL_RAND = ((0.022, 0.032), (1.3e-5, 1.5e-5), (1.3e-5, 1.5e-5), (2.07e-5, 2.27e-5))
INIT_RAND = ((-0.5, 0.5), (-0.01, 0.01), (-0.5, 0.5), (-0.01, 0.01), (0.1, 1.5),
             (-0.01, 0.01), (-0.3, 0.3), (-0.3, 0.3), (-0.3, 0.3), (-0.01, 0.01),
             (-0.01, 0.01), (-0.01, 0.01))
TILT = 85.0 * math.pi / 180.0
BOUNDS = ((-5.0, 5.0), None, (-5.0, 5.0), None, (0.0, 2.5), None, (-TILT, TILT),
          (-TILT, TILT), (-math.pi, math.pi), None, None, None)
NOMINAL = (MASS,) + J

# Yardstick counts.  The control step: the rigid-body derivative (71 and 6
# transcendentals), an RK4 substep (4 derivatives, 3 axpy and the combine
# of 12 rows), 4 substeps; per motor the normalized action map and the PWM
# actuation (10 and a square root); the figure-8 goal (48 and a sine and a
# cosine), the out-of-bound tests (36), the reward (50 and an exponential),
# done (3) and the reciprocal of the mass.
_FC = 71 + 6
_SUBSTEP = 4 * _FC + 3 * 12 * 2 + 12 * 7
STEP_OPS = 4 * _SUBSTEP + 4 * (3 + 10 + 1) + 48 + 2 + 36 + 50 + 1 + 3 + 1
# Rows a policy kernel reads and writes per env: state, inertia, counters,
# statistics, seed.
STATE_ROWS = 27


def _projection(point, normal):
    n = np.asarray(normal, np.float64)[:3]
    n = n / np.linalg.norm(n)
    M = np.eye(4)
    M[:3, :3] -= np.outer(n, n)
    M[:3, 3] = np.dot(np.asarray(point, np.float64)[:3], n) * n
    return tuple(tuple(float(v) for v in M[k, :4]) for k in range(3))


def params(env: dict) -> dict:
    if env.get("quad_type") != 3:
        raise ValueError("the quad3d family implements the 3D quadrotor")
    ti = env.get("task_info", {})
    if env["task"] != "traj_tracking" or ti.get("trajectory_type") != "figure8":
        raise ValueError("the quad3d family implements figure-8 tracking")
    inert = INERTIAL_RAND if env.get("randomized_inertial_prop", False) else ((0.0, 0.0),) * 4
    init = INIT_RAND if env.get("randomized_init", True) else ((0.0, 0.0),) * 12
    period = env["episode_len_sec"] / float(ti.get("num_cycles", 1))
    axes = {"x": 0, "y": 1, "z": 2}
    plane = ti.get("trajectory_plane", "xy")
    return dict(rand=tuple(inert) + tuple(init), hover=GRAVITY * MASS / 4.0,
                act_scale=float(env.get("norm_act_scale", 0.1)),
                traj_w=2.0 * math.pi / period, traj_scale=float(ti.get("trajectory_scale", 1.0)),
                plane_idx=(axes[plane[0]], axes[plane[1]]),
                plane_off=tuple(float(v) for v in ti.get("trajectory_position_offset", (0, 0))),
                proj=_projection(ti.get("proj_point", (0, 0, 0)),
                                 ti.get("proj_normal", (0, 0, 1))))


def action_map(p, a):
    """The commanded action -> per-motor thrust."""
    return (1.0 + p["act_scale"] * torch.clamp(a, -1.0, 1.0)) * p["hover"]


def _actuate(t):
    pwm = div(torch.sqrt(div(torch.clamp_min(t, 0.0), KF)) - PWM2RPM_CONST, PWM2RPM_SCALE)
    rpm = PWM2RPM_SCALE * torch.clamp(pwm, MIN_PWM, MAX_PWM) + PWM2RPM_CONST
    return rpm * rpm * KF


def _deriv(s, f, minv, j, l_sq2):
    vx, vy, vz, phi, theta, psi, p, q, r = s[1], s[3], s[5], s[6], s[7], s[8], s[9], s[10], s[11]
    f1, f2, f3, f4 = f
    T = f1 + f2 + f3 + f4
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    zero = torch.zeros_like(T)
    ax = ((cpsi * sth * cphi + spsi * sphi) * T + zero) * minv
    ay = ((spsi * sth * cphi - cpsi * sphi) * T + zero) * minv
    az = ((cth * cphi) * T + zero) * minv - GRAVITY
    mx = l_sq2 * (f1 + f2 - f3 - f4)
    my = l_sq2 * (-f1 + f2 + f3 - f4)
    mz = (KM / KF) * (f1 - f2 + f3 - f4)
    jx, jy, jz = j
    gx = q * (jz * r) - r * (jy * q)
    gy = r * (jx * p) - p * (jz * r)
    gz = p * (jy * q) - q * (jx * p)
    tth = sth / cth
    return (vx, ax, vy, ay, vz, az, p + sphi * tth * q + cphi * tth * r, cphi * q - sphi * r,
            sphi / cth * q + cphi / cth * r, (mx - gx) / jx, (my - gy) / jy, (mz - gz) / jz)


def goal_rows(p, step_f):
    """The figure-8's goal state at control-step rows ``step_f``."""
    t = step_f * p["ctrl_dt"]
    w, sc = p["traj_w"], p["traj_scale"]
    sw, cw = torch.sin(w * t), torch.cos(w * t)
    a_p, b_p, a_v, b_v = sc * sw, sc * sw * cw, sc * w * cw, sc * w * (cw * cw - sw * sw)
    zero = torch.zeros_like(t)
    p3, v3 = [zero] * 3, [zero] * 3
    ia, ib = p["plane_idx"]
    p3[ia], p3[ib] = a_p + p["plane_off"][0], b_p + p["plane_off"][1]
    v3[ia], v3[ib] = a_v, b_v
    goal = [zero] * 12
    for k, M in enumerate(p["proj"]):
        goal[2 * k] = M[0] * p3[0] + M[1] * p3[1] + M[2] * p3[2] + M[3]
        goal[2 * k + 1] = M[0] * v3[0] + M[1] * v3[1] + M[2] * v3[2] + M[3]
    return goal


def advance(p, s, inert, thrust):
    ug = p["hover"]
    act_cost = sum((t - ug) * (t - ug) for t in thrust) * p["rew_act_w"]
    forces = tuple(_actuate(t) for t in thrust)
    minv, l_sq2 = 1.0 / inert[0], ARM_L / (2.0**0.5)
    s = rk4(tuple(s), lambda sv: _deriv(sv, forces, minv, inert[1:], l_sq2), p["n_sub"], p["dt"])
    tests = [(s[k], lo, hi) for k, b in enumerate(BOUNDS) if b for lo, hi in [b]]
    return list(s), act_cost, tests, None
