"""Philox-4x32-10 counter generator: the port's in-kernel step noise.

The JAX package draws in-kernel randomness from the TPU core PRNG
(``safe_control_gym_tpu/parallel/fast_env.py::make_draw``,
``pltpu.prng_random_bits``), whose bits exist only on that chip.  The port
replaces it with Philox-4x32-10 (Salmon et al., SC'11; the Random123
constants), keyed on the call's seed and counted by (env, step, draw
block, call site): draw ``i`` at call site ``c`` of env ``e`` at step ``t``
of a call with seed ``s`` is word ``i % 4`` of
``philox4x32_10(ctr=(e, t, i // 4, c), key=(s, 0))``.  The call sites
(the TPU kernels' ``salt`` argument, ``fast_cartpole.py:121,327``,
``fast_env.py:342,369``) are :data:`SITE_POLICY` (the policy's Gaussian
sample), :data:`SITE_ACTION` (action white noise), :data:`SITE_OBS`
(observation white noise) and :data:`SITE_DYNAMICS` (per-step draws on the
dynamics channel: the uniform force, the TPU kernel's salt 2.0).  The
CUDA kernels compute the same words in native ``uint32`` arithmetic
(``csrc/philox.cuh``), so a kernel and its plain version draw the same
uniforms bit for bit.

The general engine's white-noise disturbances (``envs/disturbances.py``)
draw from the same generator keyed on the env's identity instead:
:func:`block_uniforms` with ``key=(env_seed, episode_idx)`` and
``ctr=(ctrl_step, entry, block, site)``.

As in ``ops/ctr_prng.py``, the words are non-negative int64 tensors masked
to 32 bits; the 32x32 -> 64-bit product is split into 16-bit halves so that
no intermediate leaves int64.
"""

from __future__ import annotations

import math

import torch

_U32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # key bumps (Weyl sequence)
ROUNDS = 10
SITE_POLICY, SITE_ACTION, SITE_OBS, SITE_DYNAMICS = 0, 1, 2, 3  # 4th counter word: the call site
# Observation white noise (call site 2): the policy's observation draws
# from blocks 0.., the terminal observation's fresh draws from this block
# on (csrc/philox.cuh::OBS_TERM_BLOCK).
OBS_TERM_BLOCK = 32
TWO_PI = 2.0 * math.pi


def _mulhilo(x, m: int):
    """(hi, lo) 32-bit words of the 64-bit product of uint32 words ``x``
    (int64 tensor) and the constant ``m``."""
    p_lo = (x & 0xFFFF) * m  # < 2^48
    mid = (x >> 16) * m + (p_lo >> 16)  # product >> 16, < 2^49
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox-4x32-10 on broadcastable int64 tensors of uint32 words."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_unit(bits):
    """uint32 words -> float32 uniforms in [0, 1): the top 24 bits times
    2^-24 (``_bits_to_unit`` in the JAX package)."""
    return (bits >> 8).to(torch.float32) * 2.0**-24


def _word(x, device):
    """An int or int tensor as uint32 words (non-negative int64).  An int
    becomes a fill on ``device``, not a host-to-device copy."""
    if not torch.is_tensor(x):
        return torch.full((), int(x) & _U32, dtype=torch.int64, device=device)
    return x.to(torch.int64) & _U32


def block_uniforms(c0, c1, c3, k0, k1, n: int, block0: int = 0):
    """(n, *shape) float32 uniforms: draw ``i`` is word ``i % 4`` of
    ``philox4x32_10(ctr=(c0, c1, block0 + i // 4, c3), key=(k0, k1))``.
    Each argument is an int or an int tensor (int32 bit patterns are taken
    as uint32 words); tensors broadcast against ``c0``."""
    c0 = _word(c0, None)
    c1, c3, k0, k1 = (_word(v, c0.device) for v in (c1, c3, k0, k1))
    out = []
    for blk in range(block0, block0 + (n + 3) // 4):
        out.extend(philox4x32(c0, c1, torch.full_like(c0, blk), c3, k0, k1))
    return torch.stack([bits_to_unit(w) for w in out[:n]])


def uniforms(seed, step: int, env, n: int, site: int = SITE_POLICY, block0: int = 0):
    """(n, *env.shape) float32 uniforms: draws 0..n-1 at call site ``site``
    of each env at ``step`` of the call keyed by ``seed``, counted from
    draw block ``block0``.

    ``seed``: int or int32 tensor of one element; ``env``: int tensor of env
    indices."""
    k0 = torch.as_tensor(seed, device=env.device).to(torch.int64).reshape(())
    return block_uniforms(env, step, site, k0, 0, n, block0)


def seed_tensor(seed, device):
    """An int or int32 tensor seed as the (1,) int32 tensor the kernels take."""
    return seed if torch.is_tensor(seed) else torch.tensor([seed], dtype=torch.int32, device=device)


def seed_ok(seed, dev):
    """The call seed a kernel takes: one int32 on the rows' device."""
    return seed.numel() == 1 and seed.dtype == torch.int32 and seed.device == dev


def box_muller(u, n: int):
    """n standard normals from 2n uniforms ``u`` (radius draws first, then
    angle draws): ``sqrt(-2 log(1 - u_r)) * cos(2 pi u_a)``, with ``2 pi``
    one float32 constant as in the kernels."""
    return torch.sqrt(-2.0 * torch.log(1.0 - u[:n])) * torch.cos(TWO_PI * u[n:2 * n])
