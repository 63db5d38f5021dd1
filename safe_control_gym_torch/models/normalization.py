"""Normalization utilities: angle wrapping, running normalizers, rescaling.

Port of ``safe_control_gym_tpu/models/normalization.py`` (reference
normalization.py:10-240).  The JAX package's normalizers are immutable
PyTrees updated functionally; here they hold plain tensors and update in
place.  ``__call__`` still returns ``(out, self)``, so call sites read as
in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def normalize_angle(x):
    """Wrap angle to [-pi, pi) (reference normalization.py:10-14); tensors
    and NumPy arrays alike."""
    return ((x + np.pi) % (2 * np.pi)) - np.pi


class RunningMeanStd:
    """Parallel-variance running mean/var (reference normalization.py:17-65);
    updated in place."""

    def __init__(self, shape=(), dtype=torch.float32, epsilon=1e-4, device=None):
        self.mean = torch.zeros(shape, dtype=dtype, device=device)
        self.var = torch.ones(shape, dtype=dtype, device=device)
        self.count = torch.tensor(epsilon, dtype=dtype, device=device)
        # (mean, var, n) of this process's batch -> those of the whole batch
        # across the ranks of a data-parallel step
        # (parallel/distributed.py::sharded_train_step); None: the batch is
        # the whole batch.
        self.reduce = None

    def update(self, batch):
        """Fold in a batch (leading axis = samples)."""
        batch = batch.reshape(-1, *self.mean.shape)
        batch_mean = batch.mean(0)
        batch_var = batch.var(0, correction=0)
        n = batch.shape[0]
        if self.reduce is not None:
            batch_mean, batch_var, n = self.reduce(batch_mean, batch_var, n)
        delta = batch_mean - self.mean
        tot = self.count + n
        new_mean = self.mean + delta * n / tot
        m2 = self.var * self.count + batch_var * n + delta**2 * self.count * n / tot
        self.mean, self.var, self.count = new_mean, m2 / tot, tot
        return self

    @property
    def std(self):
        return torch.sqrt(self.var)


class MeanStdNormalizer:
    """Standardize inputs with running statistics (reference
    normalization.py:85-124)."""

    def __init__(self, shape, dtype=torch.float32, clip=10.0, epsilon=1e-8,
                 read_only=False, device=None):
        self.rms = RunningMeanStd(shape, dtype, device=device)
        self.clip = clip
        self.epsilon = epsilon
        self.read_only = read_only

    def __call__(self, x, update=True):
        if update and not self.read_only:
            self.rms.update(x)
        out = torch.clamp((x - self.rms.mean) / torch.sqrt(self.rms.var + self.epsilon),
                          -self.clip, self.clip)
        return out, self


class RewardStdNormalizer:
    """Scale rewards by the std of the discounted return (reference
    normalization.py:127-163)."""

    def __init__(self, num_envs, dtype=torch.float32, gamma=0.99, clip=10.0,
                 epsilon=1e-8, device=None):
        self.rms = RunningMeanStd((), dtype, device=device)
        self.ret = torch.zeros(num_envs, dtype=dtype, device=device)
        self.gamma = gamma
        self.clip = clip
        self.epsilon = epsilon

    def __call__(self, rewards, dones, update=True):
        ret = self.ret * self.gamma + rewards
        if update:
            self.rms.update(ret)
        out = torch.clamp(rewards / torch.sqrt(self.rms.var + self.epsilon), -self.clip, self.clip)
        self.ret = torch.where(dones.to(torch.bool), torch.zeros_like(ret), ret)
        return out, self


class RescaleNormalizer:
    """Constant rescale (reference normalization.py:187-206)."""

    def __init__(self, coef: float = 1.0):
        self.coef = coef

    def __call__(self, x, update=False):
        return x * self.coef, self


class ActionUnnormalizer:
    """Map [-1, 1] policy outputs to the action box ``[low, high]``
    (reference normalization.py:221-240)."""

    def __init__(self, low, high):
        self.low = low
        self.high = high

    def __call__(self, action):
        a = torch.clamp(action, -1.0, 1.0)
        return self.low + (a + 1.0) * 0.5 * (self.high - self.low)
