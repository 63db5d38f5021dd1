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
// logstd (4), w2^T padded where H is not a multiple of 32 (policy_mlp.cuh).
// Hidden widths 1..128: H = 64 has its own instance.
//
// Design: one thread per env, its 27 rows in registers for the whole call
// (as K2).  The dual MLP and the Gaussian sample are csrc/policy_mlp.cuh's,
// shared with K6 and K8: the packed layout's zero blocks are skipped, the
// actor and then the critic run apart, the first hidden layer is walked one
// unit at a time into the H second-layer sums held in registers, each
// weight read with __ldg as a warp-wide broadcast.  Every sum adds its terms
// in input order, as the plain version's loop does, and the library is
// built with -fmad=false, so kernel and plain version round alike.  The
// TPU's double-buffered record DMA is not needed: a store does not stall
// the thread.
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
#include "policy_mlp.cuh"
#include "quad3d.cuh"

namespace {

using scg::RolloutParams;

constexpr int TRAJ_ROWS = 33;
constexpr int T_ACT = 12, T_REW = 16, T_DONE = 17, T_TRUNC = 18, T_V = 19, T_LOGP = 20, T_TERM = 21;
constexpr int BLOCK = 64;

struct PolicyParams {
  int normalized, relu;
  float norm_act_scale, hover_thrust;
};

// H: the hidden width, 64, or 0 for a width h read at run time (1..128).
template <int H>
__global__ void __launch_bounds__(BLOCK) quad3d_policy_rollout_kernel(
    const RolloutParams P, const PolicyParams Q, const int* __restrict__ seed_ptr,
    const float* __restrict__ w, int h, const float* __restrict__ rows_in,
    float* __restrict__ rows_out, float* __restrict__ traj, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);

  scg::EnvRows r;
  scg::load_rows(rows_in, B, e, r);
  scg::StepOut o;

  for (int it = 0; it < P.steps; ++it) {
    float obs[scg::NX];
#pragma unroll
    for (int k = 0; k < scg::NX; ++k) obs[k] = r.s[k];

    // -- the actor's and the critic's forward (means and value), the
    // Gaussian sample and its log-prob (fast_policy.py:141-161), the
    // normalized action map.
    float mean[4], value, act[4], thr[4], logp;
    scg::dual_mlp<scg::NX, 4, H>(w, h, obs, Q.relu, mean, value);
    scg::gaussian_sample<scg::NX, 4, H>(w, h, mean, e, it, seed, act, logp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      thr[i] = Q.normalized ? (1.0f + Q.norm_act_scale * scg::clipf(act[i], -1.0f, 1.0f)) * Q.hover_thrust
                            : scg::clipf(act[i], P.a_low, P.a_high);

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
  if (hidden < 1 || hidden > scg::MLP_MAX_H) return static_cast<int>(cudaErrorInvalidValue);
  if (hidden == 64) {
    quad3d_policy_rollout_kernel<64><<<grid, BLOCK, 0, st>>>(P, Q, sd, wp, hidden, ri, ro, tr, B);
  } else {
    quad3d_policy_rollout_kernel<0><<<grid, BLOCK, 0, st>>>(P, Q, sd, wp, hidden, ri, ro, tr, B);
  }
  return static_cast<int>(cudaGetLastError());
}
