"""The Gaussian actor-critic of PPO in plain PyTorch.

Two MLPs of two hidden layers (tanh or relu): the actor's means and the
critic's value, a state-independent log standard deviation.  ``precision``
names how the matrix products run: ``"float32"`` (TF32 off) or ``"tf32"``,
each operand rounded to TF32's 10-bit mantissa, round to nearest even,
before a float32 product: what a TF32 tensor core computes, written out so
that it runs the same on the CPU.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import rng

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
LEAVES = ("w1a", "b1a", "w2a", "b2a", "w3a", "b3a", "logstd",
          "w1c", "b1c", "w2c", "b2c", "w3c", "b3c")
ACTOR, CRITIC = LEAVES[:7], LEAVES[7:]


def to_tf32(x):
    """x rounded to TF32 (8-bit exponent, 10-bit mantissa), nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``x @ w.T`` with every product's operands in TF32, backward too."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return to_tf32(x) @ to_tf32(w).T

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = to_tf32(g)
        return g @ to_tf32(w), g.T @ to_tf32(x)


def linear(x, w, b, precision: str):
    if precision == "tf32":
        return _TF32MatMul.apply(x, w) + b
    if precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w.T + b


def _act(name):
    if name == "tanh":
        return torch.tanh
    if name == "relu":
        return torch.relu
    raise ValueError(f"no activation {name!r}")


def forward(w, obs, act: str, precision: str):
    """Means (N, nu) and values (N,) of observations (N, D)."""
    f = _act(act)
    h = f(linear(obs, w["w1a"], w["b1a"], precision))
    h = f(linear(h, w["w2a"], w["b2a"], precision))
    mean = linear(h, w["w3a"], w["b3a"], precision)
    c = f(linear(obs, w["w1c"], w["b1c"], precision))
    c = f(linear(c, w["w2c"], w["b2c"], precision))
    return mean, linear(c, w["w3c"], w["b3c"], precision)[:, 0]


def sample(mean, logstd, seed, step, env):
    """Actions and their log-probabilities: ``mean + exp(logstd) * eps``, eps
    by Box-Muller on the call's Philox uniforms at ``step`` of ``env``."""
    nu = mean.shape[1]
    eps = rng.box_muller(rng.step_uniforms(seed, step, env, 2 * nu), nu)
    act = []
    logp = torch.zeros_like(mean[:, 0])
    for i in range(nu):
        act.append(mean[:, i] + torch.exp(logstd[i]) * eps[i])
        logp = logp - 0.5 * (eps[i] * eps[i]) - logstd[i] - HALF_LOG_2PI
    return torch.stack(act, 1), logp


def log_prob(mean, logstd, act):
    var = torch.exp(2.0 * logstd)
    return (-((act - mean) ** 2) / (2.0 * var) - logstd - HALF_LOG_2PI).sum(-1)


def entropy(logstd):
    return (0.5 + HALF_LOG_2PI + logstd).sum()
