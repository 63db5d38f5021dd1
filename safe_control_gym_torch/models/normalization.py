"""Running normalizers.

Port of ``safe_control_gym_tpu/models/normalization.py`` (reference
normalization.py:17-163).  The JAX package's normalizers are immutable
PyTrees updated functionally; here they hold plain tensors and update in
place.  ``__call__`` still returns ``(out, self)``, so call sites read as
in the JAX package.
"""

from __future__ import annotations

import torch


class RunningMeanStd:
    """Parallel-variance running mean/var (reference normalization.py:17-65);
    updated in place."""

    def __init__(self, shape=(), dtype=torch.float32, epsilon=1e-4, device=None):
        self.mean = torch.zeros(shape, dtype=dtype, device=device)
        self.var = torch.ones(shape, dtype=dtype, device=device)
        self.count = torch.tensor(epsilon, dtype=dtype, device=device)

    def update(self, batch):
        """Fold in a batch (leading axis = samples)."""
        batch = batch.reshape(-1, *self.mean.shape)
        batch_mean = batch.mean(0)
        batch_var = batch.var(0, correction=0)
        n = batch.shape[0]
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
