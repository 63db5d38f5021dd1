"""The 2D quadrotor (quad_type 2: x, x_dot, z, z_dot, theta, theta_dot and
two motor-grouped thrusts): cf2x constants, PWM actuation of each command's
pair of motors, RK4 substeps of the planar rigid body, stabilization at a
static goal, the exponential RL reward and out-of-bound done.  The
constants are frozen copies of upstream's URDF and YAML defaults; the
arithmetic keeps the order of the upstream equations as the program under
test states them, one rounding an operation.

A reset draws four inertial values (mass, Ixx, Iyy, Izz: slots 0-3 of the
counter stream) ahead of the state for every quad type; the planar body
reads the mass and Iyy alone.  ``advance`` takes
the inertia as the four draws, or as the pair (mass, Iyy) that the
program's rows hold (``portbench/calibrate.py``'s control starts from the
program's rows) where that pair cannot be mistaken: see :func:`mass_iyy`."""

from __future__ import annotations

import math

import torch

from portbench.families import quad3d
from portbench.families.quad3d import ARM_L, J, MASS, TILT, _actuate
from portbench.reference.envs import GRAVITY, div, rk4

FIELDS = {"quad_type", "ctrl_freq", "pyb_freq", "episode_len_sec", "task", "task_info",
          "cost", "normalized_rl_action_space", "norm_act_scale",
          "randomized_inertial_prop", "randomized_init", "rew_state_weight",
          "rew_act_weight", "rew_exponential", "done_on_out_of_bound"}
DIMS = (6, 2)
N_INERTIAL = 4  # mass and the inertia diagonal
N_SLOTS = 4 + 6 + 1  # inertia, state, the impulse offset (unused here)

N_MOTOR = 2  # motors a thrust command drives: (T1, T2, T2, T1)
# Upstream's randomization of the planar quad keeps the mass and Iyy.
INERTIAL_RAND = ((0.022, 0.032), (0.0, 0.0), (1.3e-5, 1.5e-5), (0.0, 0.0))
INIT_RAND = ((-0.5, 0.5), (-0.01, 0.01), (0.1, 1.5), (-0.01, 0.01), (-0.3, 0.3), (-0.01, 0.01))
BOUNDS = ((0, -5.0, 5.0), (2, 0.0, 2.5), (4, -TILT, TILT))  # (state row, low, high)
NOMINAL = (MASS,) + J

# Yardstick counts.  The control step: per command the normalized action
# map (3) and the actuation of its motors (11 and a square root), the
# action cost (8), the motor sums and the pitch acceleration (9) and the
# reciprocal of the mass; 4 RK4 substeps, each 4 derivatives (9 and a sine
# and a cosine), 3 axpy of 6 rows and the combine of 6 rows; the
# out-of-bound tests (12), the reward (24 and an exponential), the finite
# test and the freeze (24 + 7), done and the time limit (5).
_FC = 9 + 2
_SUBSTEP = 4 * _FC + 3 * 6 * 2 + 6 * 7
STEP_OPS = 2 * (3 + 11 + 1) + 8 + 9 + 1 + 4 * _SUBSTEP + 12 + 24 + 1 + 24 + 7 + 5
# Rows a policy kernel reads and writes per env: state, mass and Iyy, the
# step, the impulse offset, statistics, seed, episode.
STATE_ROWS = 6 + 13


def params(env: dict) -> dict:
    if env.get("quad_type") != 2:
        raise ValueError("the quad2d family implements the 2D quadrotor")
    if env["task"] != "stabilization":
        raise ValueError("the quad2d family implements stabilization")
    goal = (env.get("task_info") or {}).get("stabilization_goal", (0, 1))
    inert = INERTIAL_RAND if env.get("randomized_inertial_prop", False) else ((0.0, 0.0),) * 4
    init = INIT_RAND if env.get("randomized_init", True) else ((0.0, 0.0),) * 6
    return dict(rand=tuple(inert) + tuple(init), hover=GRAVITY * MASS / DIMS[1],
                act_scale=float(env.get("norm_act_scale", 0.1)),
                x_goal=(float(goal[0]), 0.0, float(goal[1]), 0.0, 0.0, 0.0))


# The commanded action -> the thrust of a command: (1 + scale * clip(a)) * hover.
action_map = quad3d.action_map


def goal_rows(p, step_f):
    return [torch.full_like(step_f, v) for v in p["x_goal"]]


def mass_iyy(p, inert):
    """(mass, Iyy) of the four draws, or of the program's pair (mass, Iyy).

    A rollout that starts from the pair and zips it with a reset's four
    draws holds (mass, Ixx) in the reset envs, so the pair is taken only
    where the Ixx and Iyy draws are one constant (neither randomized, the
    same nominal); elsewhere it raises rather than guess which draw it
    holds."""
    if len(inert) == N_INERTIAL:
        return inert[0], inert[2]
    (lo_x, hi_x), (lo_y, hi_y) = p["rand"][1], p["rand"][2]
    one = lo_x == hi_x and lo_y == hi_y and p["nominal"][1] + lo_x == p["nominal"][2] + lo_y
    if len(inert) != 2 or not one:
        raise ValueError(f"{len(inert)} inertial values: the planar body takes the {N_INERTIAL} "
                         "draws, or the pair (mass, Iyy) only where Ixx and Iyy are drawn alike")
    return inert[0], inert[1]


def advance(p, s, inert, thrust):
    ug = p["hover"]
    act_cost = sum(p["rew_act_w"] * (t - ug) * (t - ug) for t in thrust)
    f = [_actuate(div(torch.clamp_min(t, 0.0), float(N_MOTOR))) for t in thrust]
    mass, iyy = mass_iyy(p, inert)
    minv = 1.0 / mass
    zero = torch.zeros_like(mass)
    t_sum = (f[0] + f[0]) + (f[1] + f[1])
    theta_dd = div(ARM_L * ((f[1] + f[1]) - (f[0] + f[0])) / iyy, math.sqrt(2.0))

    def deriv(sv):
        x_dd = torch.sin(sv[4]) * t_sum * minv + zero * minv
        z_dd = torch.cos(sv[4]) * t_sum * minv - GRAVITY + zero * minv
        return (sv[1], x_dd, sv[3], z_dd, sv[5], theta_dd)

    s_new = rk4(tuple(s), deriv, p["n_sub"], p["dt"])
    finite = torch.ones_like(s[0], dtype=torch.bool)
    for v in s_new:
        finite = finite & (v == v) & (v.abs() < 3.0e38)
    # A state that left the float range keeps its last finite value.
    s = [torch.where(finite, a, b) for a, b in zip(s_new, s)]
    tests = [(s[k], lo, hi) for k, lo, hi in BOUNDS]
    return s, act_cost, tests, finite
