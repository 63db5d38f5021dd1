"""Action distributions.

Port of ``safe_control_gym_tpu/models/distributions.py``: the diagonal
Normal (reference distributions.py:9-39), whose ``log_prob`` and
``entropy`` sum over the last dim and whose ``mode()`` is the mean, and the
Categorical over logits (:42-72), whose mode is the argmax.  Sampling takes
an explicit ``torch.Generator`` (agreement with the JAX package's draws is
in distribution only).
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


class Categorical:
    """Categorical over the last dim of ``logits`` (normalized to
    log-probabilities)."""

    def __init__(self, logits):
        self.logits = logits - torch.logsumexp(logits, -1, keepdim=True)

    def sample(self, generator: torch.Generator | None = None):
        probs = self.logits.exp().reshape(-1, self.logits.shape[-1])
        draws = torch.multinomial(probs, 1, generator=generator)
        return draws.reshape(self.logits.shape[:-1])

    def log_prob(self, value):
        return torch.gather(self.logits, -1, value[..., None].long())[..., 0]

    def entropy(self):
        return -(self.logits.exp() * self.logits).sum(-1)

    def mode(self):
        return self.logits.argmax(-1)
