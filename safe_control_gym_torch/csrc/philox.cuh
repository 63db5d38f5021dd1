// Philox-4x32-10 counter generator (Random123 constants): the port's
// replacement for the TPU core PRNG of the JAX package's kernels
// (safe_control_gym_tpu/parallel/fast_env.py::make_draw).  Draw i at call
// site c of env e at step t of a call keyed by seed s is word i % 4 of
// philox4x32_10(ctr = {e, t, i / 4, c}, key = {s, 0}); the plain PyTorch
// version (ops/philox.py) computes the same words.  The call sites take the
// place of the TPU kernels' salt argument.
#pragma once

#include <cstdint>

namespace scg {

constexpr uint32_t SITE_POLICY = 0;  // the policy's Gaussian sample
constexpr uint32_t SITE_ACTION = 1;  // action white noise
constexpr uint32_t SITE_OBS = 2;     // observation white noise
constexpr uint32_t SITE_DYNAMICS = 3;  // per-step draws on the dynamics channel (uniform force)
// Observation white noise (SITE_OBS): the policy's observation draws from
// blocks 0.., the terminal observation's fresh draws from this block on.
constexpr uint32_t OBS_TERM_BLOCK = 32;
constexpr float TWO_PI = 6.283185307179586476925286766559f;

struct Philox4 {
  uint32_t w[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return Philox4{{c0, c1, c2, c3}};
}

// Top 24 bits -> float32 uniform in [0, 1) (exact: the integer is < 2^24).
__device__ __forceinline__ float bits_to_unit(uint32_t b) {
  return static_cast<float>(b >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

}  // namespace scg
