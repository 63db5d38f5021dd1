"""The two counter generators the simulated envs draw from, in plain PyTorch.

Philox-4x32-10 (Salmon et al., SC'11, the Random123 constants) keys the
per-step draws: draw ``i`` at call site ``c`` of env ``e`` at step ``t`` of a
call with seed ``s`` is word ``i % 4`` of ``philox(ctr=(e, t, i // 4, c),
key=(s, 0))``, mapped to ``[0, 1)`` by its top 24 bits.  A murmur3-style
32-bit finalizer keys the reset draws: slot ``k`` of episode ``n`` of the
env with seed ``es``.  Both are frozen copies of the arithmetic the program
under test states for its kernels; the words live in non-negative int64
tensors masked to 32 bits.
"""

from __future__ import annotations

import math

import torch

U32 = 0xFFFFFFFF
SITE_POLICY = 0
TWO_PI = 2.0 * math.pi

_PM0, _PM1 = 0xD2511F53, 0xCD9E8D57
_PW0, _PW1 = 0x9E3779B9, 0xBB67AE85
_SLOT_GOLD = 0x9E3779B9
_EP_GOLD = 0x85EBCA6B
_HM1, _HM2 = 0x7FEB352D, 0x846CA68B


def _mulhilo(x, m: int):
    p_lo = (x & 0xFFFF) * m
    mid = (x >> 16) * m + (p_lo >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox-4x32-10 on broadcastable int64 tensors of uint32 words."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PW0) & U32, (k1 + _PW1) & U32
        hi0, lo0 = _mulhilo(c0, _PM0)
        hi1, lo1 = _mulhilo(c2, _PM1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _word(x, like):
    if torch.is_tensor(x):
        return x.to(torch.int64) & U32
    return torch.full((), int(x) & U32, dtype=torch.int64, device=like.device)


def step_uniforms(seed, step, env, n: int, site: int = SITE_POLICY):
    """(n, *shape) float32 uniforms of call ``seed`` (int or one-element
    int tensor) at control steps ``step`` (int or tensor) of envs ``env``
    (int tensor), broadcast together."""
    env = env.to(torch.int64)
    k0 = _word(seed.reshape(()) if torch.is_tensor(seed) else seed, env)
    c1, c3, k1 = _word(step, env), _word(site, env), _word(0, env)
    words = []
    for blk in range((n + 3) // 4):
        words.extend(philox4x32(env, c1, torch.full_like(env, blk), c3, k0, k1))
    return torch.stack([(w >> 8).to(torch.float32) * 2.0**-24 for w in words[:n]])


def box_muller(u, n: int):
    """n standard normals from 2n uniforms (radius draws, then angle draws)."""
    return torch.sqrt(-2.0 * torch.log(1.0 - u[:n])) * torch.cos(TWO_PI * u[n:2 * n])


def _mul(x, m: int):
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & U32


def _mix(x):
    x = x ^ (x >> 16)
    x = _mul(x, _HM1)
    x = x ^ (x >> 15)
    x = _mul(x, _HM2)
    return x ^ (x >> 16)


def env_seeds(seed: int, num_envs: int, device):
    """The envs' 32-bit seeds for a job seed, as uint32 words (int64)."""
    s = _mix(torch.tensor([int(seed) & U32], dtype=torch.int64, device=device))
    i = torch.arange(num_envs, dtype=torch.int64, device=device)
    return _mix((s + _mul(i, _SLOT_GOLD)) & U32)


def episode_uniforms(env_seed, episode, n_slots: int):
    """(n_slots, *shape) float32 uniforms of reset slots 0..n_slots-1 of
    episode ``episode`` (int tensor) of envs ``env_seed`` (uint32 words)."""
    base = _mix((env_seed & U32) ^ _mix(_mul(episode.to(torch.int64) & U32, _EP_GOLD)))
    slots = torch.arange(n_slots, dtype=torch.int64, device=base.device) * _SLOT_GOLD
    slots = slots.reshape((n_slots,) + (1,) * base.dim())
    return (_mix((slots + base) & U32) & 0x00FFFFFF).to(torch.float32) * 2.0**-24
