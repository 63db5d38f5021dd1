// K3: policy-in-kernel whole rollout of the 3D quadrotor, the PPO data
// collection of one train step in one launch.
//
// Replaces safe_control_gym_tpu/parallel/fast_policy.py::
// _policy_rollout_kernel (:76): per control step, the dual actor+critic MLP
// forward on the observation, a Box-Muller Gaussian sample from the
// in-kernel generator, its log-prob, the normalized-action map, the shared
// env step (scg::env_step_group, also K2's) and one record of the trajectory.
// Plain version: safe_control_gym_torch/parallel/fast_policy.py::
// policy_rollout_plain.  Envelope: that of K2 plus the normalized action
// space; the observation white noise and the goal-horizon observation rows
// of the TPU kernel are not ported (fast_env.supports refuses them).
//
// Layout: state rows (27, B) as K2; record (T, 33, B), row r of step t and
// env e at (t*33 + r)*B + e: obs 0..11 | act 12..15 | rew 16 | done 17 |
// trunc 18 | v 19 | logp 20 | terminal obs 21..32 (post-step state times
// trunc), the JAX record rows (fast_policy.py:62-71) with the batch last so
// that consecutive envs' stores are neighbours.  Weights: one flat vector of
// the packed dual network (pack_weights, fast_policy.py:296-330) in kernel
// orientation: w1 (2H, 12) | b1 (2H) | w2^T (2H, 2H) | b2 (2H) | w3^T (2H,
// 8) | b3 (8) | logstd (4), w2^T padded where H is not a multiple of 32
// (policy_mlp.cuh).  Hidden widths 1..128: H = 64 has its own instance.
//
// Design: one env over a group of K3_GROUP lanes of a warp
// (csrc/lane_group.cuh), its 27 rows in every lane's registers for the
// whole call.  The dual MLP splits over the group (scg::dual_mlp_group):
// lane j computes every G-th first-layer unit of both nets into the group's
// row of shared memory, owns a share of the second-layer units of each net
// as whole sums over k in order, and one lane a net output, each a sum over
// j in order; weights are read with __ldg, a broadcast to the warp's other
// groups.  The Gaussian sample and the normalized action map run on every
// lane alike (policy_mlp.cuh::gaussian_sample), the control step is K2's
// grouped step (scg::env_step_group), and the group's lane 0 stores the
// record.  Every sum adds its terms in input order, as the plain version's
// loop does, and the library is built with -fmad=false, so kernel and plain
// version round alike.
//
// Bound on an H100: operations.  Per env-step the two forwards are
// 2*(12*2H + 2*H*H + H*(4+1)) flops (~20k at H = 64, ~74k at H = 128)
// beside K2's ~2.3k step, and the record is 132 bytes; at B = 4096 and
// T = 128 that is ~1.2e10 operations at H = 64 (~0.18 ms at 67 TFLOP/s;
// ~0.60 ms at H = 128) against 69 MB of record (21 us at 3.35 TB/s).  One
// thread per env gave 128 warps, one chain each; the group gives K3_GROUP
// times as many warps, whose MLP work is 1/K3_GROUP of an env's and whose
// step chain is K2's grouped one (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "lane_group.cuh"
#include "philox.cuh"
#include "policy_mlp.cuh"
#include "quad3d.cuh"

// Lanes per env, at every width: 4 and 16 were slower at H = 64 and 128
// (PERF.md).
#ifndef K3_GROUP
#define K3_GROUP 8
#endif

namespace {

using scg::RolloutParams;

constexpr int TRAJ_ROWS = 33;
constexpr int T_ACT = 12, T_REW = 16, T_DONE = 17, T_TRUNC = 18, T_V = 19, T_LOGP = 20, T_TERM = 21;
constexpr int BLOCK = 128;  // the largest block the launch plan asks for

struct PolicyParams {
  int normalized, relu;
  float norm_act_scale, hover_thrust;
};

// H: the hidden width, 64, or 0 for a width h read at run time (1..128).
// G: lanes per env.  The launch bound names one block an SM: with the block size alone ptxas held
// the H = 64 instance at 128 registers and spilled (PERF.md).
template <int H, int G>
__global__ void __launch_bounds__(BLOCK, 1) quad3d_policy_rollout_kernel(
    const RolloutParams P, const PolicyParams Q, const int* __restrict__ seed_ptr,
    const float* __restrict__ w, int h, const float* __restrict__ rows_in,
    float* __restrict__ rows_out, float* __restrict__ traj, int B) {
  extern __shared__ float smem[];
  const scg::LaneGroup g = scg::lane_group<G>(B);
  float* sh = smem + (threadIdx.x / G) * scg::mlp_group_row(H > 0 ? H : h);
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  const bool store = g.valid && g.gl == 0;

  scg::EnvRows r;
  scg::load_rows(rows_in, B, g.e, r);
  scg::StepOut o;

  for (int it = 0; it < P.steps; ++it) {
    float obs[scg::NX];
#pragma unroll
    for (int k = 0; k < scg::NX; ++k) obs[k] = r.s[k];

    // -- the actor's and the critic's forward (means and value), the
    // Gaussian sample and its log-prob (fast_policy.py:141-161), the
    // normalized action map.
    float mean[4], value, act[4], thr[4], logp;
    scg::dual_mlp_group<scg::NX, 4, H, G>(w, h, obs, Q.relu, sh, g, mean, value);
    scg::gaussian_sample<scg::NX, 4, H>(w, h, mean, g.e, it, seed, act, logp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      thr[i] = Q.normalized ? (1.0f + Q.norm_act_scale * scg::clipf(act[i], -1.0f, 1.0f)) * Q.hover_thrust
                            : scg::clipf(act[i], P.a_low, P.a_high);

    // -- shared env step (dynamics, reward, done, statistics, auto-reset).
    const scg::ActionTerms a = scg::action_terms(P, thr, act);
    scg::env_step_group<G>(P, r, a, o, g);

    // -- one record column.
    if (store) {
      float* rec = traj + static_cast<size_t>(it) * TRAJ_ROWS * B + g.e;
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
  }
  if (store) scg::store_rows(rows_out, B, g.e, r);
}

template <int H, int G>
int launch(const RolloutParams& P, const PolicyParams& Q, const int* sd, const float* wp,
           int h, const float* ri, float* ro, float* tr, int B, int block, int grid, int smem,
           cudaStream_t st) {
  auto kern = quad3d_policy_rollout_kernel<H, G>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<grid, block, smem, st>>>(P, Q, sd, wp, h, ri, ro, tr, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 2: the entry takes the launch plan (fast_policy.py::launch_plan).
extern "C" int quad3d_policy_rollout_api_version() { return 2; }

extern "C" int quad3d_policy_rollout(const void* params, int normalized, int relu,
                                     float norm_act_scale, float hover_thrust, int hidden,
                                     const void* seed, const void* wflat, const void* rows_in,
                                     void* rows_out, void* traj, int B, int group, int block,
                                     int grid, int smem, void* stream) {
  if (hidden < 1 || hidden > scg::MLP_MAX_H || group != K3_GROUP || block < 32 || block > BLOCK ||
      block % 32 != 0 || static_cast<long long>(grid) * (block / group) < B ||
      smem < (block / group) * scg::mlp_group_row(hidden) * static_cast<int>(sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  const RolloutParams P = *static_cast<const RolloutParams*>(params);
  const PolicyParams Q{normalized, relu, norm_act_scale, hover_thrust};
  const auto* sd = static_cast<const int*>(seed);
  const auto* wp = static_cast<const float*>(wflat);
  const auto* ri = static_cast<const float*>(rows_in);
  auto* ro = static_cast<float*>(rows_out);
  auto* tr = static_cast<float*>(traj);
  const auto st = static_cast<cudaStream_t>(stream);
  return hidden == 64
             ? launch<64, K3_GROUP>(P, Q, sd, wp, hidden, ri, ro, tr, B, block, grid, smem, st)
             : launch<0, K3_GROUP>(P, Q, sd, wp, hidden, ri, ro, tr, B, block, grid, smem, st);
}
