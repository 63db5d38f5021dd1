"""The cart-pole: RK4 of the cart and pole, stabilization at the origin,
the exponential RL reward and the x / theta thresholds.  The constants
are frozen copies of upstream's ``cartpole.py`` and its YAML defaults; the
arithmetic keeps the order of the upstream equations as the program under
test states them, one rounding an operation."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.envs import GRAVITY, rk4

FIELDS = {"ctrl_freq", "pyb_freq", "episode_len_sec", "task", "cost",
          "normalized_rl_action_space", "randomized_init", "randomized_inertial_prop",
          "rew_state_weight", "rew_act_weight", "rew_exponential", "done_on_out_of_bound"}
DIMS = (4, 1)
N_INERTIAL = 3  # pole length, pole mass, cart mass
N_SLOTS = 8

NOMINAL = (1.0, 0.1, 1.0)
INIT_RAND = ((-0.05, 0.05),) * 4
FORCE, X_LIMIT, THETA_LIMIT = 10.0, 2.4, 90.0 * np.pi / 180.0

# Yardstick counts.  The control step: the derivative (18 and a sine and a
# cosine), one RK4 substep (4 derivatives, 3 axpy and the combine of 4
# rows), the action map (3), the box tests (4), the reward (10 and an
# exponential), done and the finite test (8).
_FC = 18 + 2
STEP_OPS = 4 * _FC + 3 * 4 * 2 + 4 * 7 + 3 + 4 + 10 + 1 + 8
# Rows a policy kernel reads and writes per env: state, inertia, counters,
# statistics, seed.
STATE_ROWS = 18


def params(env: dict) -> dict:
    if env["task"] != "stabilization":
        raise ValueError("the cartpole family implements stabilization")
    inert = [(-0.05, 0.05)] * 3 if env.get("randomized_inertial_prop", False) else \
        [(0.0, 0.0)] * 3
    init = INIT_RAND if env.get("randomized_init", True) else ((0.0, 0.0),) * 4
    return dict(rand=tuple(inert) + tuple(init))


def action_map(p, a):
    """The commanded action -> the force on the cart."""
    return FORCE * torch.clamp(a, -1.0, 1.0)


def _deriv(s, force, half_l, Mm, ml, pm):
    sin_t, cos_t = torch.sin(s[2]), torch.cos(s[2])
    temp = (force + ml * (s[3] * s[3]) * sin_t) / Mm
    theta_dd = (GRAVITY * sin_t - cos_t * temp) / (half_l * (4.0 / 3.0 - pm * (cos_t * cos_t) / Mm))
    return (s[1], temp - ml * theta_dd * cos_t / Mm, s[3], theta_dd)


def goal_rows(p, step_f):
    return [torch.zeros_like(step_f) for _ in range(4)]


def advance(p, s, inert, thrust):
    act_cost = p["rew_act_w"] * thrust[0] * thrust[0]
    pl, pm, cm = inert
    half_l = pl / 2.0
    Mm = cm + pm
    ml = pm * half_l
    s_new = rk4(tuple(s), lambda sv: _deriv(sv, thrust[0], half_l, Mm, ml, pm),
                p["n_sub"], p["dt"])
    finite = torch.ones_like(s[0], dtype=torch.bool)
    for v in s_new:
        finite = finite & (v == v) & (v.abs() < 3.0e38)
    # A state that left the float range keeps its last finite value.
    s = [torch.where(finite, a, b) for a, b in zip(s_new, s)]
    tests = [(s[0].abs(), -math.inf, X_LIMIT), (s[2].abs(), -math.inf, THETA_LIMIT)]
    return s, act_cost, tests, finite
