"""The port's counter PRNG against the JAX package's, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from safe_control_gym_torch.ops import ctr_prng as tp
from safe_control_gym_tpu.ops import ctr_prng as jp

N = 4096


def _seeds():
    rng = np.random.default_rng(0)
    seeds = rng.integers(-2**31, 2**31, N, dtype=np.int64).astype(np.int32)
    # Edge words: zero, extremes, and float32 NaN bit patterns (seeds ride
    # the fast engine's f32 rows as bit patterns).
    edge = np.array([0, -1, 1, 2**31 - 1, -2**31, 0x7FC00000, -0x00400000,
                     0x7F800001], np.int64).astype(np.int32)
    seeds[:edge.size] = edge
    eps = rng.integers(0, 2**31, N, dtype=np.int64).astype(np.int32)
    eps[:4] = [0, 1, 2**31 - 1, 7]
    return seeds, eps


def test_mix32_and_episode_base_bit_exact():
    seeds, eps = _seeds()
    np.testing.assert_array_equal(
        tp.mix32(torch.from_numpy(seeds)).numpy(), np.asarray(jp.mix32(jnp.asarray(seeds))))
    np.testing.assert_array_equal(
        tp.episode_base(torch.from_numpy(seeds), torch.from_numpy(eps)).numpy(),
        np.asarray(jp.episode_base(jnp.asarray(seeds), jnp.asarray(eps))))


def test_uniform_slots_and_slot_uniform_bit_exact():
    seeds, eps = _seeds()
    base_j = jp.episode_base(jnp.asarray(seeds), jnp.asarray(eps))
    base_t = tp.episode_base(torch.from_numpy(seeds), torch.from_numpy(eps))
    u_t = tp.uniform_slots(base_t, 17)
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(jp.uniform_slots(base_j, 17)))
    assert u_t.dtype == torch.float32
    for slot in (0, 5, 16):
        np.testing.assert_array_equal(
            tp.slot_uniform(base_t, slot).numpy(), np.asarray(jp.slot_uniform(base_j, slot)))


def test_seed_rows_round_trip():
    seeds, _ = _seeds()
    es = torch.from_numpy(seeds)
    row = tp.seed_to_row(es)
    assert row.dtype == torch.float32
    np.testing.assert_array_equal(row.numpy().view(np.int32), seeds)
    np.testing.assert_array_equal(tp.seed_from_row(row).numpy(), seeds)
    # The same bit pattern as the JAX package's row payload.
    np.testing.assert_array_equal(row.numpy().view(np.int32),
                                  jp.seed_to_row(seeds).view(np.int32))
    back = jax.jit(jp.seed_from_row)(jnp.asarray(jp.seed_to_row(seeds)))
    np.testing.assert_array_equal(np.asarray(back), seeds)


def test_env_seeds_from_seed_distinct_and_reproducible():
    a = tp.env_seeds_from_seed(3, N)
    assert a.dtype == torch.int32 and a.shape == (N,)
    assert torch.unique(a).numel() == N
    assert torch.equal(a, tp.env_seeds_from_seed(3, N))
    assert not torch.equal(a, tp.env_seeds_from_seed(4, N))
