"""Philox-4x32-10 counter generator: the port's in-kernel step noise.

The JAX package draws in-kernel randomness from the TPU core PRNG
(``safe_control_gym_tpu/parallel/fast_env.py::make_draw``,
``pltpu.prng_random_bits``), whose bits exist only on that chip.  The port
replaces it with Philox-4x32-10 (Salmon et al., SC'11; the Random123
constants), keyed on the call's seed and counted by (env, step, draw
block): draw ``i`` of env ``e`` at step ``t`` of a call with seed ``s`` is
word ``i % 4`` of ``philox4x32_10(ctr=(e, t, i // 4, 0), key=(s, 0))``.
The CUDA kernels compute the same words in native ``uint32`` arithmetic
(``csrc/philox.cuh``), so a kernel and its plain version draw the same
uniforms bit for bit.

As in ``ops/ctr_prng.py``, the words are non-negative int64 tensors masked
to 32 bits; the 32x32 -> 64-bit product is split into 16-bit halves so that
no intermediate leaves int64.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # key bumps (Weyl sequence)
ROUNDS = 10


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


def uniforms(seed, step: int, env, n: int):
    """(n, *env.shape) float32 uniforms: draws 0..n-1 of each env at
    ``step`` of the call keyed by ``seed``.

    ``seed``: int or int32 tensor of one element; ``env``: int tensor of env
    indices."""
    env = env.to(torch.int64) & _U32
    k0 = torch.as_tensor(seed, device=env.device).to(torch.int64).reshape(()) & _U32
    out = []
    for blk in range((n + 3) // 4):
        words = philox4x32(env, torch.full_like(env, step & _U32),
                           torch.full_like(env, blk), torch.zeros_like(env), k0, 0)
        out.extend(words)
    return torch.stack([bits_to_unit(w) for w in out[:n]])
