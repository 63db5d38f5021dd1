"""Stateful gym-style adapter over the port's batched env API.

Port of ``safe_control_gym_tpu/envs/gym_adapter.py``.  The reference
environments are ``gym.Env``s (pre-0.26 API): ``reset() -> (obs, info)``,
``step(action) -> (obs, reward, done, info)`` with
``info['TimeLimit.truncated']`` telling a timeout from a true termination
(benchmark_env.py:383,463).  The port's surface is the batched functional
pair ``reset(env_seeds) / step(state, action)`` (``envs/benchmark.py``
``FnEnv``); ``GymEnv`` drives it with a batch of one, carries the state,
and exposes the reference's single-env imperative API, numpy in and numpy
out, on the env's device.

Seeding mirrors the reference: each ``reset()`` starts the next episode's
env seed of the adapter's seed (``ops/ctr_prng.env_seeds_from_seed``: env
seed ``k`` for the ``k``-th reset), while ``reseed_on_reset=True`` replays
the first, so every episode draws identical randomization
(benchmark_env.py:210-215).  The JAX package derives its episodes' seeds
from threefry keys, which the port does not replay: the two adapters agree
from the same state, not from the same seed.

``render()`` draws the current state with ``utils/rendering`` on the host
(JAX ``envs/gym_adapter.py:134-160``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from safe_control_gym_torch.ops import ctr_prng


class Box:
    """Minimal Box space (low/high/shape/sample), enough for reference-style
    control loops; no gym dependency."""

    def __init__(self, low, high, rng: Optional[np.random.Generator] = None):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)
        self.shape = self.low.shape
        self.dtype = np.float32
        self._rng = rng or np.random.default_rng(0)

    def seed(self, seed=None):
        self._rng = np.random.default_rng(seed)
        return [seed]

    def sample(self):
        lo = np.where(np.isfinite(self.low), self.low, -1.0)
        hi = np.where(np.isfinite(self.high), self.high, 1.0)
        return self._rng.uniform(lo, hi).astype(np.float32)

    def contains(self, x):
        x = np.asarray(x)
        return bool(x.shape == self.shape and (x >= self.low).all() and (x <= self.high).all())

    def __repr__(self):
        return f"Box{self.shape}"


def _to_numpy(tree):
    """Tensors of a batch of one (and dicts of them) -> numpy, batch axis
    dropped."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()[0]
    return tree


class GymEnv:
    """Single-env, stateful, numpy-in/numpy-out wrapper over an ``FnEnv``.

    ``reset()``/``step()``/``seed()``/``close()`` follow the reference
    BenchmarkEnv surface so an existing reference control loop runs
    unchanged; the batched functional env is reachable at ``.fn_env``, and
    the state at ``.state``."""

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, env, seed: int = 0, reseed_on_reset: Optional[bool] = None):
        self.fn_env = env
        self._state = None
        self._episodes = 0
        if reseed_on_reset is None:
            reseed_on_reset = bool(getattr(env.config, "reseed_on_reset", False))
        self.reseed_on_reset = reseed_on_reset
        self.seed(seed)

        sp = env.spaces
        self.action_space = Box(sp.action_low, sp.action_high, np.random.default_rng(seed))
        self.observation_space = Box(sp.obs_low, sp.obs_high)
        # Reference-style passthrough attributes controllers read.
        self.x_goal = env.x_goal
        self.u_goal = env.u_goal
        self.CTRL_FREQ = env.ctrl_freq
        self.CTRL_TIMESTEP = env.ctrl_timestep
        self.EPISODE_LEN_SEC = env.episode_len_sec
        self.CTRL_STEPS = env.max_episode_steps

    def seed(self, seed=None):
        """Restart the episode stream (benchmark_env.py seed()); ``seed=None``
        draws fresh OS entropy (gym semantics)."""
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % (2 ** 31))
        self._seed = int(seed)
        self._episodes = 0
        if hasattr(self, "action_space"):
            self.action_space.seed(self._seed)
        return [self._seed]

    def reset(self):
        """-> (obs, info).  Advances the episode stream unless
        ``reseed_on_reset`` (then every episode replays the seed's draws)."""
        k = 0 if self.reseed_on_reset else self._episodes
        self._episodes += 1
        env_seed = ctr_prng.env_seeds_from_seed(self._seed, k + 1, self.fn_env.device)[k:]
        self._state, obs, info = self.fn_env.reset(env_seed)
        return _to_numpy(obs), _to_numpy(info)

    def step(self, action):
        """-> (obs, reward, done, info) with info['TimeLimit.truncated']
        (benchmark_env.py:458-463 semantics, emitted by the env itself)."""
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        action = np.asarray(action, np.float32).reshape((1,) + self.action_space.shape)
        a = torch.as_tensor(action, device=self.fn_env.device)
        self._state, obs, rew, done, info = self.fn_env.step(self._state, a)
        return _to_numpy(obs), float(rew[0]), bool(done[0]), _to_numpy(info)

    def render(self, mode: str = "rgb_array"):
        """One RGB frame of the current state, drawn on the host from a copy
        of the batch of one (``utils/rendering``; the interactive path is
        ``utils/viewer``)."""
        from safe_control_gym_torch.envs.cartpole import CartPoleConfig

        if self._state is None:
            raise RuntimeError("call reset() before render()")
        x = self._state.x[0].cpu().numpy()
        cfg = self.fn_env.config
        if isinstance(cfg, CartPoleConfig):
            from safe_control_gym_torch.utils.rendering import render_cartpole

            return render_cartpole(x, pole_length=float(self._state.pole_length[0]))
        from safe_control_gym_torch.utils.rendering import render_quadrotor

        xg = np.asarray(self.x_goal, float)
        xg0 = xg.reshape(-1, xg.shape[-1])[0] if xg.ndim > 1 else xg
        # The 3D state [x, x', y, y', z, z', ...] keeps its positions at 0/2/4.
        goal = xg0[[0, 2, 4]] if xg0.size >= 12 else None
        return render_quadrotor(x, quad_type=int(cfg.quad_type), gates=getattr(cfg, "gates", None),
                                obstacles=getattr(cfg, "obstacles", None), goal=goal)

    def close(self):
        self._state = None

    @property
    def state(self):
        """The env state of the batch of one (for inspection or hand-off to
        the batched API)."""
        return self._state


def make_gym_env(config=None, seed: int = 0, reseed_on_reset: Optional[bool] = None,
                 device=None, **overrides):
    """Reference-style one-call constructor: config dataclass (or None for
    the default CartPole) -> stateful GymEnv on ``device`` (CUDA by
    default).  ``overrides`` are config field replacements;
    ``reseed_on_reset`` is the adapter's episode-stream knob
    (benchmark_env.py:210-215), not a config field."""
    from safe_control_gym_torch.envs.cartpole import CartPoleConfig, make_cartpole
    from safe_control_gym_torch.envs.quadrotor import QuadrotorConfig, make_quadrotor

    if config is None:
        config = CartPoleConfig(**overrides)
    elif overrides:
        config = dataclasses.replace(config, **overrides)
    if isinstance(config, CartPoleConfig):
        env = make_cartpole(config, device=device)
    elif isinstance(config, QuadrotorConfig):
        env = make_quadrotor(config, device=device)
    else:
        raise TypeError(f"unsupported config type: {type(config)!r}")
    return GymEnv(env, seed=seed, reseed_on_reset=reseed_on_reset)
