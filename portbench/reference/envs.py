"""Plain PyTorch env steps of the benchmark's configurations.

What every family shares: the configuration's common fields, the episode
draws, RK4, the reward and done.  What a family alone has (its dynamics,
constants, goal and action map) is ``portbench/families/<family>.py``,
found by the name a configuration gives (:mod:`portbench.families`).  Each
step runs on rows: a list of ``(N,)`` float32 tensors, one a state
component, so that any batch of (env, step) pairs steps at once.
:func:`params` reads a configuration's ``env`` group and raises for a field
outside what the family's file implements.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import families
from portbench.reference import rng

GRAVITY = 9.8


def params(family: str, env: dict) -> dict:
    """The step's constants from a configuration's ``env`` group."""
    fam = families.load(family)
    extra = set(env) - fam.FIELDS
    if extra:
        raise ValueError(f"the reference does not implement {sorted(extra)} of {family}")
    if env.get("cost") != "rl_reward" or not env.get("normalized_rl_action_space"):
        raise ValueError("the reference implements the RL reward on the normalized action space")
    if not env.get("rew_exponential", True) or not env.get("done_on_out_of_bound", True):
        raise ValueError("the reference implements the exponential reward and out-of-bound done")
    nx, nu = fam.DIMS
    p = {"family": family, "nx": nx, "nu": nu, "n_inertial": fam.N_INERTIAL,
         "n_slots": fam.N_SLOTS, "nominal": tuple(fam.NOMINAL) + (0.0,) * nx,
         "ctrl_dt": 1.0 / env["ctrl_freq"],
         "n_sub": env["pyb_freq"] // env["ctrl_freq"], "dt": 1.0 / env["pyb_freq"],
         "max_steps": float(int(env["episode_len_sec"] * env["ctrl_freq"])),
         "rew_act_w": float(env.get("rew_act_weight", 1e-4)),
         "rew_state_w": tuple(np.broadcast_to(
             np.asarray(env.get("rew_state_weight", 1.0), float), (nx,)).tolist())}
    p.update(fam.params(env))
    return p


def episode_draws(p, env_seed, episode):
    """(state rows, inertial rows) of episode ``episode`` of envs ``env_seed``
    (uint32 words): nominal plus low bound plus a uniform times the span,
    in float32."""
    u = rng.episode_uniforms(env_seed, episode, p["n_slots"])
    vals = []
    for k, (nom, (lo, hi)) in enumerate(zip(p["nominal"], p["rand"])):
        vals.append((nom + lo) + u[k] * (hi - lo))
    return vals[p["n_inertial"]:], vals[:p["n_inertial"]]


def div(a, c: float):
    return a / torch.full_like(a, c)


def rk4(s, fc, n_sub, dt):
    for _ in range(n_sub):
        k1 = fc(s)
        k2 = fc(tuple(si + dt / 2 * ki for si, ki in zip(s, k1)))
        k3 = fc(tuple(si + dt / 2 * ki for si, ki in zip(s, k2)))
        k4 = fc(tuple(si + dt * ki for si, ki in zip(s, k3)))
        s = tuple(si + dt / 6 * (a + 2 * b + 2 * c + d)
                  for si, a, b, c, d in zip(s, k1, k2, k3, k4))
    return s


def step(p, s, inert, step_f, act):
    """One control step of envs in state rows ``s`` with inertial rows
    ``inert`` at control-step rows ``step_f`` under commanded actions
    ``act`` (a list of nu rows).  Returns (post-step state rows, reward,
    done (time limit included), truncated, distance of the nearest
    out-of-bound test to its bound (for ties))."""
    fam = families.load(p["family"])
    thrust = [fam.action_map(p, a) for a in act]
    s, act_cost, tests, finite = fam.advance(p, s, inert, thrust)
    goal = fam.goal_rows(p, step_f)
    dist = act_cost
    for k in range(p["nx"]):
        e = s[k] - goal[k]
        dist = dist + p["rew_state_w"][k] * e * e
    rew = torch.exp(-dist)
    done = torch.zeros_like(step_f, dtype=torch.bool)
    margin = torch.full_like(step_f, math.inf)
    for v, lo, hi in tests:
        done = done | (v < lo) | (v > hi)
        for b in (lo, hi):
            if math.isfinite(b):
                margin = torch.minimum(margin, (v - b).abs() / max(1.0, abs(b)))
    if finite is not None:
        rew = torch.where(finite, rew, torch.zeros_like(rew))
        done = done | ~finite
    timeout = step_f + 1.0 >= p["max_steps"]
    trunc = timeout & ~done
    return list(s), rew, done | timeout, trunc, margin
