"""Optimizers written out on lists of tensors.

``Adam`` is optax's ``chain(clip_by_global_norm(max_norm), adam(lr))``
(``max_norm=inf``: plain ``optax.adam``), updated in place; PPO's actor and
critic, the CBF residual model and the GP fit step with it.
"""

from __future__ import annotations

import torch


class Adam:
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr))`` on a list of
    parameters, updated in place.

    Two traps on the way from optax to torch: optax leaves the gradients as
    they are when their global norm is below ``max_norm`` and otherwise
    scales them by ``max_norm / norm``, where
    ``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)``;
    and optax's Adam divides the bias-corrected moments as
    ``mu_hat / (sqrt(nu_hat) + eps)`` (eps 1e-8, eps_root 0).  The norm is
    joint over the whole group (for the actor: MLP params and logstd,
    ppo.py:144-149)."""

    def __init__(self, params, lr: float, max_norm: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.max_norm, self.b1, self.b2, self.eps = lr, max_norm, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads, scale=None):
        """One update from ``grads`` (same order as the params), each first
        multiplied by ``scale`` (a 0-dim tensor) when given."""
        grads = [g.detach() for g in grads]
        if scale is not None:
            grads = torch._foreach_mul(grads, scale)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        clip = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        grads = torch._foreach_mul(grads, clip)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        self.count += 1
        mu_hat = torch._foreach_div(self.mu, 1.0 - self.b1**self.count)
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, 1.0 - self.b2**self.count))
        torch._foreach_add_(den, self.eps)
        torch._foreach_add_(self.params, torch._foreach_div(mu_hat, den), alpha=-self.lr)
