"""Vectorized env with masked auto-reset.

Port of ``safe_control_gym_tpu/parallel/vector.py``.  The port's envs are
batched already, so the vector env only adds the auto-reset: when an env
reports done, its state and the returned ``obs`` are those of a fresh
episode (the counter-PRNG ``reset_episode`` of the same env seed), and the
terminal observation is in ``info['terminal_observation']`` (reference
dummy_vec_env.py:40-47).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from safe_control_gym_torch.envs.benchmark import where_state
from safe_control_gym_torch.ops import ctr_prng


@dataclasses.dataclass(frozen=True)
class VecEnv:
    """Batched env.

    reset: ``(seed=0, env_seeds=None) -> (state, obs, info)``.
    step: ``(state, actions) -> (state, obs, rew, done, info)`` with
        auto-reset.
    step_no_reset: the same without auto-reset.
    """

    reset: Callable
    step: Callable
    step_no_reset: Callable
    num_envs: int
    env: Any  # underlying FnEnv


def make_vec_env(env, num_envs: int, auto_reset: bool = True) -> VecEnv:
    """Wrap a batched ``FnEnv`` (its device is the vector env's)."""
    reset_episode = env.extras["reset_episode"]

    def reset(seed: int = 0, env_seeds=None):
        """Episode 0 of every env.  ``env_seeds`` (int32, (num_envs,)) wins
        over ``seed``, whose per-env seeds come from
        ``ctr_prng.env_seeds_from_seed``."""
        if env_seeds is None:
            env_seeds = ctr_prng.env_seeds_from_seed(seed, num_envs, env.device)
        if tuple(env_seeds.shape) != (num_envs,):
            raise ValueError(f"env_seeds must have shape ({num_envs},)")
        return env.reset(env_seeds)

    def step(state, actions):
        new_state, obs, rew, done, info = env.step(state, actions)
        # Fresh episodes for done envs, computed for all and masked in.
        r_state, r_obs, _ = reset_episode(new_state)
        out_state = where_state(done, r_state, new_state)
        info = dict(info)
        info["terminal_observation"] = obs
        out_obs = torch.where(done[:, None], r_obs, obs)
        return out_state, out_obs, rew, done, info

    return VecEnv(
        reset=reset,
        step=step if auto_reset else env.step,
        step_no_reset=env.step,
        num_envs=num_envs,
        env=env,
    )
