"""Counter-based reset PRNG shared by the general and whole-rollout engines.

Port of ``safe_control_gym_tpu/ops/ctr_prng.py``: every reset draw is a pure
function of ``(env_seed, episode_index, slot)`` through a murmur3-style
32-bit finalizer, so the vectorized engine, the CUDA whole-rollout kernel
(``csrc/quad3d.cuh``) and the JAX package all produce the same uniforms bit
for bit.

torch does not promise that int32 overflow wraps, so the hash runs on
non-negative int64 values masked to 32 bits; a 32x32-bit product is split
into 16-bit halves so that no intermediate leaves int64.  Inputs and outputs
are int32 tensors (the bit pattern of the uint32 word).

The JAX package derives each env's seed from threefry key splits
(``env_seed_from_key``).  That batched stream is not reproduced here: the
port's ``reset(seed=...)`` uses :func:`env_seeds_from_seed`, and
``env_seeds=...`` takes int32 seeds from anywhere (the tests pass the seeds
JAX derives).  The one-env seed of ``jax.random.key(seed)``, which the
competition loop and the firmware wrapper reset with, is
:func:`key_env_seed`: the same course as the JAX package's for a level's
seed.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF
# Distinct 32-bit odd constants (golden-ratio / murmur3 / splitmix lineage),
# as uint32 words.
_SLOT_GOLD = 0x9E3779B9
_EP_GOLD = 0x85EBCA6B
_M1 = 0x7FEB352D
_M2 = 0x846CA68B

SEED_MASK = 0x00FFFFFF  # low-24-bit mask for the f32 uniform conversion


def _u32(x):
    """int tensor -> its uint32 word as a non-negative int64."""
    return x.to(torch.int64) & _U32


def _i32(v):
    """Non-negative int64 uint32 word -> int32 tensor with the same bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _mul(x, m: int):
    """(x * m) mod 2^32 for uint32 words x (int64 tensor) and constant m."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & _U32


def _mix(x):
    x = x ^ (x >> 16)
    x = _mul(x, _M1)
    x = x ^ (x >> 15)
    x = _mul(x, _M2)
    return x ^ (x >> 16)


def mix32(x):
    """32-bit avalanche (murmur3-finalizer variant) on int32 values."""
    return _i32(_mix(_u32(x)))


def _episode_base(env_seed, episode_idx):
    return _mix(_u32(env_seed) ^ _mix(_mul(_u32(episode_idx), _EP_GOLD)))


def episode_base(env_seed, episode_idx):
    """Per-(env, episode) hash base.  Both args int32 tensors."""
    return _i32(_episode_base(env_seed, episode_idx))


def unit(h):
    """int32 hash word -> f32 uniform in [0, 1) from its low 24 bits."""
    return (h & SEED_MASK).to(torch.float32) * 2.0**-24


def slot_uniform(base, slot: int):
    """One [0, 1) uniform for a static draw slot."""
    return unit(_mix((_u32(base) + slot * _SLOT_GOLD) & _U32))


def uniform_slots(base, n_slots: int):
    """(n_slots, *base.shape) uniforms for slots 0..n_slots-1."""
    slots = torch.arange(n_slots, dtype=torch.int64, device=base.device) * _SLOT_GOLD
    slots = slots.reshape((n_slots,) + (1,) * base.dim())
    return unit(_mix((slots + _u32(base)) & _U32))


def env_seeds_from_seed(seed: int, num_envs: int, device=None):
    """The port's per-env seeds for ``reset(seed=...)``.

    ``env_seed[i] = mix32(mix32(seed) + i * 0x9E3779B9)`` in uint32
    arithmetic.  mix32 is a bijection and the step is odd, so the envs of one
    batch never share a reset stream."""
    s = _mix(torch.tensor([int(seed) & _U32], dtype=torch.int64, device=device))
    i = torch.arange(num_envs, dtype=torch.int64, device=device)
    return _i32(_mix((s + _mul(i, _SLOT_GOLD)) & _U32))


def seed_to_row(es):
    """int32 env seeds -> f32 row payload (bit pattern, never a value cast)."""
    return es.to(torch.int32).contiguous().view(torch.float32)


def seed_from_row(row):
    """f32 row payload -> int32 env seeds (bit pattern)."""
    return row.contiguous().view(torch.int32)


def _threefry2x32(k0: int, k1: int, x0: int, x1: int):
    """Threefry-2x32 (20 rounds) of one counter pair under key (k0, k1), on
    Python ints (Salmon et al. 2011, the JAX package's default PRNG)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = (x0 + ks[0]) & _U32, (x1 + ks[1]) & _U32
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _U32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def key_env_seed(seed: int) -> int:
    """The int32 env seed the JAX package's one-env ``reset`` derives from
    ``jax.random.key(seed)`` (``env_seed_from_key``: 32 threefry bits of the
    key (0, seed), counter (0, 0), the two output words xor-ed, as
    ``jax.random.bits`` under partitionable threefry), so that a level's
    seed draws the same course in both packages."""
    a, b = _threefry2x32((int(seed) >> 32) & _U32, int(seed) & _U32, 0, 0)
    v = a ^ b
    return v - (1 << 32) if v >= 1 << 31 else v
