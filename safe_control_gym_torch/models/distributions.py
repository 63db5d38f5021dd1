"""Action distributions.

Port of ``safe_control_gym_tpu/models/distributions.py`` for the diagonal
Normal (reference distributions.py:9-39): ``log_prob`` and ``entropy`` sum
over the last dim and ``mode()`` is the mean.  Sampling takes an explicit
``torch.Generator``.  The Categorical is not ported yet.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


class Normal:
    """Diagonal Gaussian over the last dim."""

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    def sample(self, generator: torch.Generator | None = None):
        noise = torch.randn(self.loc.shape, generator=generator, dtype=self.loc.dtype,
                            device=self.loc.device)
        return self.loc + self.scale * noise

    def log_prob(self, value):
        var = self.scale**2
        lp = -((value - self.loc) ** 2) / (2 * var) - torch.log(self.scale) - 0.5 * LOG_2PI
        return lp.sum(-1)

    def entropy(self):
        return (0.5 + 0.5 * LOG_2PI + torch.log(self.scale)).sum(-1)

    def mode(self):
        return self.loc
