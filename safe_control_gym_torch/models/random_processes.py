"""Exploration noise processes.

Port of ``safe_control_gym_tpu/models/random_processes.py`` (reference
math_and_models/random_processes.py, ddpg_utils.py:228-239).  A process
holds its state in tensors and advances in place; ``sample`` still returns
``(noise, self)`` as the JAX package's does.  Each ``sample`` draws its
standard normals from the caller's ``torch.Generator``, or takes them as
``eps`` (a test replays the JAX package's draws that way).
"""

from __future__ import annotations

import torch


def _normals(generator, shape, like, eps):
    if eps is not None:
        return eps
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


class GaussianNoise:
    """i.i.d. ``N(0, std^2)``; ``std`` a float32 tensor."""

    def __init__(self, std):
        self.std = std

    def sample(self, generator, shape=None, eps=None):
        return _normals(generator, shape, self.std, eps) * self.std, self

    def reset(self):
        return self


class OrnsteinUhlenbeckNoise:
    """``dx = theta (mu - x) dt + sigma sqrt(dt) N(0, 1)``.

    ``mu``, ``theta``, ``sigma`` and ``dt`` are float32 0-dim tensors: in
    the JAX package they are pytree leaves, which ``jit`` turns into float32
    arrays, so ``sqrt(dt)`` and every product round in float32.  The state
    is never reset at an episode's end (DDPG never calls ``reset``)."""

    def __init__(self, x, mu=0.0, theta=0.15, sigma=0.2, dt=1e-2):
        self.x = x

        def f32(v):
            return torch.full((), v, dtype=torch.float32, device=x.device)

        self.mu, self.theta, self.sigma, self.dt = f32(mu), f32(theta), f32(sigma), f32(dt)

    @classmethod
    def create(cls, shape, dtype=torch.float32, device=None, **kw):
        return cls(torch.zeros(shape, dtype=dtype, device=device), **kw)

    def sample(self, generator, shape=None, eps=None):
        shape = self.x.shape if shape is None else shape
        dx = (self.theta * (self.mu - self.x) * self.dt
              + self.sigma * torch.sqrt(self.dt) * _normals(generator, shape, self.x, eps))
        self.x = self.x + dx
        return self.x, self

    def reset(self):
        self.x = torch.zeros_like(self.x)
        return self


def make_action_noise_process(spec: dict, shape, device=None):
    """The noise process a spec names (ddpg_utils.make_action_noise_process,
    :228-239): ``{"func": "gaussian" | "normal", "std"}`` or ``{"func": "ou"
    | "ornstein_uhlenbeck", "mu", "theta", "sigma", "dt"}``."""
    kind = spec.get("func", "gaussian")
    if kind in ("gaussian", "normal"):
        return GaussianNoise(torch.full((), spec.get("std", 0.1), dtype=torch.float32,
                                        device=device))
    if kind in ("ou", "ornstein_uhlenbeck"):
        return OrnsteinUhlenbeckNoise.create(
            shape, device=device, mu=spec.get("mu", 0.0), theta=spec.get("theta", 0.15),
            sigma=spec.get("sigma", 0.2), dt=spec.get("dt", 1e-2))
    raise ValueError(f"unknown noise process {kind!r}")
