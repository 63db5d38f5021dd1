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
// kernel orientation, for hidden width H and HP = H rounded up to a multiple
// of MLP_CHUNK: w1 (2H, OBS_PAD) | b1 (2H) | w2^T (2H, 2 HP) | b2 (2H) |
// w3^T (2H, 8) | b3 (8) | logstd (NU), each w1 row zero-padded to OBS_PAD =
// a multiple of 4, row u of w2^T holding the actor's columns at 0.. and the
// critic's at HP.., and b1 and b2 zero-padded to a multiple of 4
// (fast_policy.py::kernel_weights), so every float4 load is aligned and a
// chunk's loads stay inside its net's zero-padded columns.  At H = 64 that
// is the plain packed layout.  Output rows 0..NU-1 of w3 are the actor's means, row NU the value.
//
// Design: one thread per env; the packed layout's zero blocks are skipped,
// the actor and then the critic run apart; the first hidden layer is walked
// one unit k at a time and folded into the second layer's sums, which stay
// in registers; every thread of a warp reads the same weight address, a
// broadcast from L1.  H is a template parameter: a fixed width (64, the
// PPOConfig default) keeps the whole layer's sums in registers; H = 0 takes the width at run
// time (1..128, the JAX kernels' limit) and walks the first layer once for
// each chunk of at most MLP_CHUNK = 32 second-layer units, recomputing h1_k
// with the same operations.  Padding never enters a sum: padded
// columns only reach sums that are dropped.  Every sum adds its terms in
// input order, as the plain version's loop does, and the library is built
// with -fmad=false, so kernel and plain version round alike.
//
// K3, K6 and K8 run its lane-group form, lane_group.cuh::dual_mlp_group
// (the same sums, split over 8 lanes), and gaussian_sample on every lane of
// the group.  K6 and K8 at one lane an env (their plans' pick at large B)
// run dual_mlp itself: there the group form's shared-memory row (1,040
// bytes an env at H = 64) capped the envs an SM holds, 1.38-2.47x slower
// than this (PERF.md).
#pragma once

#include <cstdint>

#include "philox.cuh"

namespace scg {

constexpr int MLP_MAX_H = 128;  // the JAX kernels' limit (fast_policy.py:227)
// Second-layer sums a run-time-width net holds in registers at a time: at
// 64 the K6 instance spilled (ptxas kept it at 128 registers).  Each net's
// w2^T columns are padded to a multiple of it, so a chunk loads all of its
// columns without a bound test (with one, K6 and the 1D K8 spilled).
constexpr int MLP_CHUNK = 32;
constexpr float HALF_LOG_2PI = 0.918938533204672741780329736406f;

__device__ __forceinline__ float act_fn(float z, int relu) {
  return relu ? ((z > 0.0f || z != z) ? z : 0.0f) : tanhf(z);  // jnp.maximum keeps NaN
}

__device__ __forceinline__ float4 ld4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }

// Layout of a fixed width H (a multiple of 4): compile-time offsets.
template <int OBS, int H>
struct MlpLayout {
  static constexpr int H2 = 2 * H;
  static constexpr int OBS_PAD = (OBS + 3) / 4 * 4;
  static constexpr int W1 = 0;
  static constexpr int B1 = W1 + H2 * OBS_PAD;
  static constexpr int W2T = B1 + H2;
  static constexpr int B2 = W2T + H2 * H2;
  static constexpr int W3T = B2 + H2;
  static constexpr int B3 = W3T + H2 * 8;
  static constexpr int LOGSTD = B3 + 8;
};

// Layout of a width h read at run time, HP = h rounded up to a multiple of
// MLP_CHUNK; the same offsets as MlpLayout<OBS, h> where h is one.
template <int OBS>
struct MlpDims {
  static constexpr int OBS_PAD = (OBS + 3) / 4 * 4;
  int H, HP, W1, B1, W2T, B2, W3T, B3, LOGSTD;
  __device__ explicit MlpDims(int h)
      : H(h), HP((h + MLP_CHUNK - 1) / MLP_CHUNK * MLP_CHUNK), W1(0), B1(2 * h * OBS_PAD), W2T(B1 + (2 * h + 3) / 4 * 4),
        B2(W2T + 2 * h * 2 * HP), W3T(B2 + (2 * h + 3) / 4 * 4), B3(W3T + 2 * h * 8),
        LOGSTD(B3 + 8) {}
};

// The layout at a width h and an observation of d rows, both read at run
// time (the observation instances, obs_ext.cuh): MlpDims<d>(h)'s offsets.
struct MlpDimsD {
  int OBS_PAD, H, HP, W1, B1, W2T, B2, W3T, B3, LOGSTD;
  __device__ MlpDimsD(int h, int d)
      : OBS_PAD((d + 3) / 4 * 4), H(h), HP((h + MLP_CHUNK - 1) / MLP_CHUNK * MLP_CHUNK), W1(0),
        B1(2 * h * OBS_PAD), W2T(B1 + (2 * h + 3) / 4 * 4), B2(W2T + 2 * h * 2 * HP),
        W3T(B2 + (2 * h + 3) / 4 * 4), B3(W3T + 2 * h * 8), LOGSTD(B3 + 8) {}
};

// One net of the packed pair at fixed width H: hidden units [base, base + H)
// of both layers (base 0 the actor, H the critic) and its NO output rows
// from o0.  Writes those rows' sums, before the output bias.
template <int OBS, int NO, int H>
__device__ __forceinline__ void mlp_net(const float* __restrict__ w, int base, int o0,
                                        const float* obs, int relu, float* out) {
  using L = MlpLayout<OBS, H>;
  const float* W1 = w + L::W1;
  const float* B1 = w + L::B1;
  const float* W2T = w + L::W2T;
  const float* B2 = w + L::B2;
  const float* W3T = w + L::W3T;
  // h1_k = f(w1[k] . obs + b1[k]) one unit at a time, folded into the
  // second layer's sums acc[j] += w2[j][k] * h1_k.
  float acc[H];
  for (int k = 0; k < H; ++k) {
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
    const float* col = W2T + u * L::H2 + base;
    if (k == 0) {
#pragma unroll
      for (int j = 0; j < H; j += 4) {
        const float4 v = ld4(col + j);
        acc[j] = v.x * h;
        acc[j + 1] = v.y * h;
        acc[j + 2] = v.z * h;
        acc[j + 3] = v.w * h;
      }
    } else {
#pragma unroll
      for (int j = 0; j < H; j += 4) {
        const float4 v = ld4(col + j);
        acc[j] = acc[j] + v.x * h;
        acc[j + 1] = acc[j + 1] + v.y * h;
        acc[j + 2] = acc[j + 2] + v.z * h;
        acc[j + 3] = acc[j + 3] + v.w * h;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < H; ++j) {
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

// The same net at a width read at run time (net 0 the actor, 1 the
// critic), in chunks of at most MLP_CHUNK second-layer units: each chunk
// walks the whole first layer again, and a chunk's output terms follow the
// previous chunk's, so every sum keeps the fixed-width order.  Past the
// net's width a chunk sums zero-padded columns into sums that are dropped.
template <int OBS, int NO>
__device__ __forceinline__ void mlp_net_wide(const float* __restrict__ w, const MlpDims<OBS>& L,
                                             int net, int o0, const float* obs, int relu,
                                             float* out) {
  constexpr int OBS_PAD = MlpDims<OBS>::OBS_PAD;
  const int base = net * L.H;
  float acc[MLP_CHUNK];
  for (int c0 = 0; c0 < L.H; c0 += MLP_CHUNK) {
    const int n = min(MLP_CHUNK, L.H - c0);
    for (int k = 0; k < L.H; ++k) {
      const int u = base + k;
      float wr[OBS_PAD];
#pragma unroll
      for (int c = 0; c < OBS_PAD; c += 4) {
        const float4 v = ld4(w + L.W1 + u * OBS_PAD + c);
        wr[c] = v.x;
        wr[c + 1] = v.y;
        wr[c + 2] = v.z;
        wr[c + 3] = v.w;
      }
      float z = wr[0] * obs[0];
#pragma unroll
      for (int c = 1; c < OBS; ++c) z = z + wr[c] * obs[c];
      const float h = act_fn(z + __ldg(w + L.B1 + u), relu);
      const float* col = w + L.W2T + u * 2 * L.HP + net * L.HP + c0;
#pragma unroll
      for (int j = 0; j < MLP_CHUNK; j += 4) {
        const float4 v = ld4(col + j);
        if (k == 0) {
          acc[j] = v.x * h;
          acc[j + 1] = v.y * h;
          acc[j + 2] = v.z * h;
          acc[j + 3] = v.w * h;
        } else {
          acc[j] = acc[j] + v.x * h;
          acc[j + 1] = acc[j + 1] + v.y * h;
          acc[j + 2] = acc[j + 2] + v.z * h;
          acc[j + 3] = acc[j + 3] + v.w * h;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MLP_CHUNK; ++j) {
      if (j < n) {
        const int u = base + c0 + j;
        const float h = act_fn(acc[j] + __ldg(w + L.B2 + u), relu);
        const float* row = w + L.W3T + u * 8 + o0;
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
        for (int i = 0; i < NO; ++i) out[i] = c0 + j == 0 ? t[i] : out[i] + t[i];
      }
    }
  }
}

// The actor's NU means and the critic's value on one observation, at the
// fixed width H, or for H = 0 at the width h.
template <int OBS, int NU, int H>
__device__ __forceinline__ void dual_mlp(const float* __restrict__ w, int h, const float* obs,
                                         int relu, float* mean, float& value) {
  float out[NU + 1];
  int b3;
  if constexpr (H > 0) {
    mlp_net<OBS, NU, H>(w, 0, 0, obs, relu, out);
    mlp_net<OBS, 1, H>(w, H, NU, obs, relu, out + NU);
    b3 = MlpLayout<OBS, H>::B3;
  } else {
    const MlpDims<OBS> L(h);
    mlp_net_wide<OBS, NU>(w, L, 0, 0, obs, relu, out);
    mlp_net_wide<OBS, 1>(w, L, 1, NU, obs, relu, out + NU);
    b3 = L.B3;
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) mean[i] = out[i];  // the bias joins in gaussian_sample
  value = out[NU] + __ldg(w + b3 + NU);
}

// act = (mean + b3) + exp(logstd) * eps and its log-prob, eps by
// Box-Muller on Philox draws of call site 0 (radius draws 0..NU-1, angle
// draws NU..2NU-1; draw d is word d % 4 of block d / 4); b3 and ls0: the
// offsets of the output bias and of logstd in w.
template <int NU>
__device__ __forceinline__ void gaussian_sample_at(const float* __restrict__ w, int b3, int ls0,
                                                   const float* mean, int e, int it, uint32_t seed,
                                                   float* act, float& logp) {
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
    const float ls = __ldg(w + ls0 + i);
    act[i] = (mean[i] + __ldg(w + b3 + i)) + expf(ls) * eps;
    logp = logp - 0.5f * (eps * eps) - ls - HALF_LOG_2PI;
  }
}

// gaussian_sample_at with the offsets of the fixed width H, or for H = 0
// of the width h, at an observation of OBS rows.
template <int OBS, int NU, int H>
__device__ __forceinline__ void gaussian_sample(const float* __restrict__ w, int h, const float* mean,
                                                int e, int it, uint32_t seed, float* act, float& logp) {
  int b3, ls0;
  if constexpr (H > 0) {
    b3 = MlpLayout<OBS, H>::B3;
    ls0 = MlpLayout<OBS, H>::LOGSTD;
  } else {
    const MlpDims<OBS> L(h);
    b3 = L.B3;
    ls0 = L.LOGSTD;
  }
  gaussian_sample_at<NU>(w, b3, ls0, mean, e, it, seed, act, logp);
}

}  // namespace scg
