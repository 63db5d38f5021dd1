// The policy-in-kernel rollouts' dual actor+critic MLP and Gaussian sample
// (K3 quad3d_policy_rollout, K6 cartpole_policy_rollout, K8
// quad_planar_policy_rollout), templated on the observation width and the
// number of actions.
//
// Replaces the forward and sampling of the TPU kernels' _policy_rollout_kernel
// (safe_control_gym_tpu/parallel/fast_policy.py,
// parallel/fast_cartpole.py:309-337, parallel/fast_quad_planar.py:703-740).
// Plain versions:
// safe_control_gym_torch/parallel/fast_policy.py::dual_mlp and
// ::gaussian_sample.
//
// Weights: one flat vector of the packed dual network (pack_weights) in
// kernel orientation: w1 (2H, OBS_PAD) | b1 (2H) | w2^T (2H, 2H) | b2 (2H) |
// w3^T (2H, 8) | b3 (8) | logstd (NU), each w1 row zero-padded to
// OBS_PAD = a multiple of 4 (fast_policy.py::kernel_weights), so every float4
// load is aligned.  Output rows 0..NU-1 of w3 are the actor's means, row NU
// the value.
//
// Design: one thread per env; the
// packed layout's zero blocks are skipped, the actor and then the critic run
// apart; the first hidden layer is walked one unit k at a time and folded
// into the H second-layer sums, which stay in registers; every thread of a
// warp reads the same weight address, a broadcast from L1.  Every sum adds
// its terms in input order, as the plain version's loop does, and the
// library is built with -fmad=false, so kernel and plain version round
// alike.
#pragma once

#include <cstdint>

#include "philox.cuh"

namespace scg {

constexpr int MLP_H = 64;  // hidden width of each net, the PPOConfig default
constexpr int MLP_H2 = 2 * MLP_H;
constexpr float HALF_LOG_2PI = 0.918938533204672741780329736406f;

__device__ __forceinline__ float act_fn(float z, int relu) {
  return relu ? ((z > 0.0f || z != z) ? z : 0.0f) : tanhf(z);  // jnp.maximum keeps NaN
}

__device__ __forceinline__ float4 ld4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }

template <int OBS>
struct MlpLayout {
  static constexpr int OBS_PAD = (OBS + 3) / 4 * 4;
  static constexpr int W1 = 0;
  static constexpr int B1 = W1 + MLP_H2 * OBS_PAD;
  static constexpr int W2T = B1 + MLP_H2;
  static constexpr int B2 = W2T + MLP_H2 * MLP_H2;
  static constexpr int W3T = B2 + MLP_H2;
  static constexpr int B3 = W3T + MLP_H2 * 8;
  static constexpr int LOGSTD = B3 + 8;
};

// One net of the packed pair: hidden units [base, base + H) of both layers
// (base 0 the actor, H the critic) and its NO output rows from o0.  Writes
// those rows' sums, before the output bias.
template <int OBS, int NO>
__device__ __forceinline__ void mlp_net(const float* __restrict__ w, int base, int o0,
                                        const float* obs, int relu, float* out) {
  using L = MlpLayout<OBS>;
  const float* W1 = w + L::W1;
  const float* B1 = w + L::B1;
  const float* W2T = w + L::W2T;
  const float* B2 = w + L::B2;
  const float* W3T = w + L::W3T;
  // h1_k = f(w1[k] . obs + b1[k]) one unit at a time, folded into the
  // second layer's sums acc[j] += w2[j][k] * h1_k.
  float acc[MLP_H];
  for (int k = 0; k < MLP_H; ++k) {
    const int u = base + k;
    float wr[L::OBS_PAD];
#pragma unroll
    for (int c = 0; c < L::OBS_PAD; c += 4) {
      const float4 v = ld4(W1 + u * L::OBS_PAD + c);
      wr[c] = v.x;
      wr[c + 1] = v.y;
      wr[c + 2] = v.z;
      wr[c + 3] = v.w;
    }
    float z = wr[0] * obs[0];
#pragma unroll
    for (int c = 1; c < OBS; ++c) z = z + wr[c] * obs[c];
    const float h = act_fn(z + __ldg(B1 + u), relu);
    const float* col = W2T + u * MLP_H2 + base;
    if (k == 0) {
#pragma unroll
      for (int j = 0; j < MLP_H; j += 4) {
        const float4 v = ld4(col + j);
        acc[j] = v.x * h;
        acc[j + 1] = v.y * h;
        acc[j + 2] = v.z * h;
        acc[j + 3] = v.w * h;
      }
    } else {
#pragma unroll
      for (int j = 0; j < MLP_H; j += 4) {
        const float4 v = ld4(col + j);
        acc[j] = acc[j] + v.x * h;
        acc[j + 1] = acc[j + 1] + v.y * h;
        acc[j + 2] = acc[j + 2] + v.z * h;
        acc[j + 3] = acc[j + 3] + v.w * h;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < MLP_H; ++j) {
    const float h = act_fn(acc[j] + __ldg(B2 + base + j), relu);
    const float* row = W3T + (base + j) * 8 + o0;
    float t[NO];
    if constexpr (NO == 4) {
      const float4 v = ld4(row);
      t[0] = v.x * h;
      t[1] = v.y * h;
      t[2] = v.z * h;
      t[3] = v.w * h;
    } else {
#pragma unroll
      for (int i = 0; i < NO; ++i) t[i] = __ldg(row + i) * h;
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) out[i] = j == 0 ? t[i] : out[i] + t[i];
  }
}

// The actor's NU means and the critic's value on one observation.
template <int OBS, int NU>
__device__ __forceinline__ void dual_mlp(const float* __restrict__ w, const float* obs, int relu,
                                         float* mean, float& value) {
  using L = MlpLayout<OBS>;
  float out[NU + 1];
  mlp_net<OBS, NU>(w, 0, 0, obs, relu, out);
  mlp_net<OBS, 1>(w, MLP_H, NU, obs, relu, out + NU);
#pragma unroll
  for (int i = 0; i < NU; ++i) mean[i] = out[i];  // the bias joins in gaussian_sample
  value = out[NU] + __ldg(w + L::B3 + NU);
}

// act = (mean + b3) + exp(logstd) * eps and its log-prob, eps by
// Box-Muller on Philox draws of call site 0 (radius draws 0..NU-1, angle
// draws NU..2NU-1; draw d is word d % 4 of block d / 4).
template <int OBS, int NU>
__device__ __forceinline__ void gaussian_sample(const float* __restrict__ w, const float* mean, int e,
                                                int it, uint32_t seed, float* act, float& logp) {
  using L = MlpLayout<OBS>;
  const Philox4 u0 = philox4x32_10(e, it, 0, SITE_POLICY, seed, 0);
  Philox4 u1 = u0;
  if constexpr (2 * NU > 4) u1 = philox4x32_10(e, it, 1, SITE_POLICY, seed, 0);
  logp = 0.0f;
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    const int dr = i, da = NU + i;
    const uint32_t br = dr < 4 ? u0.w[dr & 3] : u1.w[dr & 3];
    const uint32_t ba = da < 4 ? u0.w[da & 3] : u1.w[da & 3];
    const float ua = 1.0f - bits_to_unit(br);  // (0, 1]: keeps the log finite
    const float ub = bits_to_unit(ba);
    const float eps = sqrtf(-2.0f * logf(ua)) * cosf(TWO_PI * ub);
    const float ls = __ldg(w + L::LOGSTD + i);
    act[i] = (mean[i] + __ldg(w + L::B3 + i)) + expf(ls) * eps;
    logp = logp - 0.5f * (eps * eps) - ls - HALF_LOG_2PI;
  }
}

}  // namespace scg
