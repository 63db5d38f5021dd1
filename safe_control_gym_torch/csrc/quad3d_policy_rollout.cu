// K3: policy-in-kernel whole rollout of the 3D quadrotor, the PPO data
// collection of one train step in one launch.
//
// Replaces safe_control_gym_tpu/parallel/fast_policy.py::
// _policy_rollout_kernel (:76): per control step, the dual actor+critic MLP
// forward on the observation, a Box-Muller Gaussian sample from the
// in-kernel generator, its log-prob, the normalized-action map, the shared
// env step (scg::env_step, also K2's) and one record of the trajectory.
// Plain version: safe_control_gym_torch/parallel/fast_policy.py::
// policy_rollout_plain.  Envelope: that of K2 plus the normalized action
// space; the observation white noise and the goal-horizon observation rows
// of the TPU kernel are not ported (fast_env.supports refuses them).
//
// Layout: state rows (27, B) as K2; record (T, 33, B), row r of step t and
// env e at (t*33 + r)*B + e: obs 0..11 | act 12..15 | rew 16 | done 17 |
// trunc 18 | v 19 | logp 20 | terminal obs 21..32 (post-step state times
// trunc), the JAX record rows (fast_policy.py:62-71) with the batch last so
// that each store coalesces.  Weights: one flat vector of the packed dual
// network (pack_weights, fast_policy.py:296-330) in kernel orientation:
// w1 (2H, 12) | b1 (2H) | w2^T (2H, 2H) | b2 (2H) | w3^T (2H, 8) | b3 (8) |
// logstd (4).
//
// Design: one thread per env, its 27 rows in registers for the whole call
// (as K2).  The packed layout is the TPU's MXU layout: its off-diagonal w2
// blocks and the padding of w3 are zero.  The kernel skips them and runs
// the actor, then the critic (mlp_net): it walks the net's first hidden
// layer one unit k at a time and adds that unit's column of the net's w2
// block into the H second-layer sums, which stay in registers (H is a
// compile-time constant); each weight is read with __ldg as float4, and
// every thread of a warp reads the same address, so each load is a
// broadcast from L1.  Every sum adds its terms in input order k = 0.., as
// the plain version's loop does, and the library is built with
// -fmad=false, so kernel and plain version round alike.  The TPU's
// double-buffered record DMA is not needed: a store does not stall the
// thread.
//
// Bound on an H100: operations.  Per env-step the two forwards are
// 2*(12*2H + 2*H*H + H*(4+1)) flops (~20k at H = 64) beside K2's ~2.3k
// step, and the record is 132 bytes; at B = 4096 and T = 128 that is
// ~1.2e10 operations (~0.18 ms at 67 TFLOP/s) against 69 MB of record
// (21 us at 3.35 TB/s).  B = 4096 threads are 128 warps, one for each of
// 128 of the card's 528 warp schedulers, so nothing hides each thread's
// load and add latency and a call runs far below that bound (PERF.md);
// spreading an env's MLP over several threads is the lever.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "quad3d.cuh"

namespace {

using scg::RolloutParams;

constexpr int TRAJ_ROWS = 33;
constexpr int T_ACT = 12, T_REW = 16, T_DONE = 17, T_TRUNC = 18, T_V = 19, T_LOGP = 20, T_TERM = 21;
constexpr int BLOCK = 64;
constexpr int H = 64;  // hidden width of each net, the PPOConfig default
constexpr int H2 = 2 * H;
constexpr float HALF_LOG_2PI = 0.918938533204672741780329736406f;
constexpr float TWO_PI = 6.283185307179586476925286766559f;

struct PolicyParams {
  int normalized, relu;
  float norm_act_scale, hover_thrust;
};

__device__ __forceinline__ float act_fn(float z, int relu) {
  return relu ? ((z > 0.0f || z != z) ? z : 0.0f) : tanhf(z);  // jnp.maximum keeps NaN
}

__device__ __forceinline__ float4 ld4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }

// One net of the packed pair: hidden units [base, base + H) of both layers
// (base 0 the actor, H the critic) and its NO output rows from o0 (actor
// 0..3, critic 4).  Writes those rows' sums, before the output bias.
template <int NO>
__device__ __forceinline__ void mlp_net(const float* __restrict__ W1, const float* __restrict__ B1,
                                        const float* __restrict__ W2T, const float* __restrict__ B2,
                                        const float* __restrict__ W3T, int base, int o0,
                                        const float* obs, int relu, float* out) {
  // h1_k = f(w1[k] . obs + b1[k]) one unit at a time, folded into the
  // second layer's sums acc[j] += w2[j][k] * h1_k.
  float acc[H];
  for (int k = 0; k < H; ++k) {
    const int u = base + k;
    const float4 wa = ld4(W1 + u * 12), wb = ld4(W1 + u * 12 + 4), wc = ld4(W1 + u * 12 + 8);
    float z = wa.x * obs[0];
    z = z + wa.y * obs[1];
    z = z + wa.z * obs[2];
    z = z + wa.w * obs[3];
    z = z + wb.x * obs[4];
    z = z + wb.y * obs[5];
    z = z + wb.z * obs[6];
    z = z + wb.w * obs[7];
    z = z + wc.x * obs[8];
    z = z + wc.y * obs[9];
    z = z + wc.z * obs[10];
    z = z + wc.w * obs[11];
    const float h = act_fn(z + __ldg(B1 + u), relu);
    const float* col = W2T + u * H2 + base;
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

__global__ void __launch_bounds__(BLOCK) quad3d_policy_rollout_kernel(
    const RolloutParams P, const PolicyParams Q, const int* __restrict__ seed_ptr,
    const float* __restrict__ w, const float* __restrict__ rows_in, float* __restrict__ rows_out,
    float* __restrict__ traj, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  // Flat weight offsets (all multiples of 4 floats: float4 loads stay aligned).
  const float* W1 = w;
  const float* B1 = W1 + H2 * 12;
  const float* W2T = B1 + H2;
  const float* B2 = W2T + H2 * H2;
  const float* W3T = B2 + H2;
  const float* B3 = W3T + H2 * 8;
  const float* LOGSTD = B3 + 8;
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);

  scg::EnvRows r;
  scg::load_rows(rows_in, B, e, r);
  scg::StepOut o;

  for (int it = 0; it < P.steps; ++it) {
    float obs[scg::NX];
#pragma unroll
    for (int k = 0; k < scg::NX; ++k) obs[k] = r.s[k];

    // -- the actor's and the critic's forward: output rows 0..3 actor mean,
    // 4 value (rows 5..7 of the packed w3 are padding and feed nothing).
    float out[5];
    mlp_net<4>(W1, B1, W2T, B2, W3T, 0, 0, obs, Q.relu, out);
    mlp_net<1>(W1, B1, W2T, B2, W3T, H, 4, obs, Q.relu, out + 4);
    const float value = out[4] + __ldg(B3 + 4);

    // -- Gaussian sample (Box-Muller on 8 Philox uniforms), log-prob from
    // eps (fast_policy.py:141-161), normalized action map.
    const scg::Philox4 u0 = scg::philox4x32_10(e, it, 0, 0, seed, 0);
    const scg::Philox4 u1 = scg::philox4x32_10(e, it, 1, 0, seed, 0);
    float act[4], thr[4], logp = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ua = 1.0f - scg::bits_to_unit(u0.w[i]);  // (0, 1]: keeps the log finite
      const float ub = scg::bits_to_unit(u1.w[i]);
      const float eps = sqrtf(-2.0f * logf(ua)) * cosf(TWO_PI * ub);
      const float ls = __ldg(LOGSTD + i);
      act[i] = (out[i] + __ldg(B3 + i)) + expf(ls) * eps;
      logp = logp - 0.5f * (eps * eps) - ls - HALF_LOG_2PI;
      thr[i] = Q.normalized ? (1.0f + Q.norm_act_scale * scg::clipf(act[i], -1.0f, 1.0f)) * Q.hover_thrust
                            : scg::clipf(act[i], P.a_low, P.a_high);
    }

    // -- shared env step (dynamics, reward, done, statistics, auto-reset).
    const scg::ActionTerms a = scg::action_terms(P, thr, act);
    scg::env_step(P, r, a, o);

    // -- one record column.
    float* rec = traj + static_cast<size_t>(it) * TRAJ_ROWS * B + e;
#pragma unroll
    for (int k = 0; k < scg::NX; ++k) rec[k * B] = obs[k];
#pragma unroll
    for (int i = 0; i < 4; ++i) rec[(T_ACT + i) * B] = act[i];
    const float truncf = o.trunc ? 1.0f : 0.0f;
    rec[T_REW * B] = o.rew;
    rec[T_DONE * B] = o.done ? 1.0f : 0.0f;
    rec[T_TRUNC * B] = truncf;
    rec[T_V * B] = value;
    rec[T_LOGP * B] = logp;
#pragma unroll
    for (int k = 0; k < scg::NX; ++k) rec[(T_TERM + k) * B] = o.s_post[k] * truncf;
  }
  scg::store_rows(rows_out, B, e, r);
}

}  // namespace

extern "C" int quad3d_policy_rollout(const void* params, int normalized, int relu,
                                     float norm_act_scale, float hover_thrust, int hidden,
                                     const void* seed, const void* wflat, const void* rows_in,
                                     void* rows_out, void* traj, int B, void* stream) {
  const RolloutParams P = *static_cast<const RolloutParams*>(params);
  const PolicyParams Q{normalized, relu, norm_act_scale, hover_thrust};
  const int grid = (B + BLOCK - 1) / BLOCK;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sd = static_cast<const int*>(seed);
  const float* wp = static_cast<const float*>(wflat);
  const float* ri = static_cast<const float*>(rows_in);
  float* ro = static_cast<float*>(rows_out);
  float* tr = static_cast<float*>(traj);
  if (hidden != H) return static_cast<int>(cudaErrorInvalidValue);
  quad3d_policy_rollout_kernel<<<grid, BLOCK, 0, st>>>(P, Q, sd, wp, ri, ro, tr, B);
  return static_cast<int>(cudaGetLastError());
}
