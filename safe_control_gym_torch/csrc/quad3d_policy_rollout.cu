// K3: policy-in-kernel whole rollout of the 3D quadrotor, the PPO data
// collection of one train step in one launch.
//
// Replaces safe_control_gym_tpu/parallel/fast_policy.py::
// _policy_rollout_kernel (:76): per control step, the dual actor+critic MLP
// forward on the observation, a Box-Muller Gaussian sample from the
// in-kernel generator, its log-prob, the normalized-action map, the shared
// env step (scg::env_step_group, also K2's) and one record of the trajectory.
// Plain version: safe_control_gym_torch/parallel/fast_policy.py::
// policy_rollout_plain.  Envelope: that of K2 with its maze, plus the
// normalized action space, the observation white noise and the
// goal-horizon observation rows (fast_env.supports(allow_normalized=True,
// allow_maze=True, allow_goal_horizon=True)), as the TPU kernel's.
//
// Layout: state rows (27, B) as K2; record (T, 2D + 9, B), D the
// observation's width (12 without goal rows), row r of step t and env e at
// (t*(2D + 9) + r)*B + e: obs 0..D-1 | act | rew | done | trunc | v | logp |
// terminal obs (the post-step observation times trunc), the JAX record rows
// (fast_policy.py:62-71) with the batch last so that consecutive envs'
// stores are neighbours.  Weights: one flat vector of the packed dual
// network (pack_weights, fast_policy.py:296-330) in kernel orientation: w1
// (2H, D) | b1 (2H) | w2^T (2H, 2H) | b2 (2H) | w3^T (2H, 8) | b3 (8) |
// logstd (4), w1 rows padded to a multiple of 4 and w2^T where H is not a
// multiple of 32 (policy_mlp.cuh).  Hidden widths 1..128: H = 64 has its
// own instance.  An observation that is more than the state (noise or goal
// rows, D up to 128) runs the observation instance (obs_ext.cuh: the
// observation row in shared memory, D and the width read at run time).  A
// config with the maze (gates, obstacles or the competition cost), the
// action white noise or the uniform dynamics force runs the maze instances
// of each (entry quad3d_policy_rollout_maze): their rows are K2's maze
// rows (27 + 4 a gate + 2 an obstacle + 4) and their step K2's maze
// instance's (maze.cuh::env_step_maze, the lanes splitting the gates,
// obstacles and noisy motors); the action noise is added to the policy's
// thrust inside the step, and the record keeps the pre-noise action.
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
#include "maze.cuh"
#include "obs_ext.cuh"
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
// G: lanes per env.  OBS: the observation instance (obs_ext.cuh; H = 0),
// its observation X; the other instances never read X.  MAZE: the maze
// instance (maze.cuh: the maze rows and the step noise); the others compile
// it out.  The launch bound names one block an SM: with the block size
// alone ptxas held the H = 64 instance at 128 registers and spilled
// (PERF.md).
template <int H, int G, bool OBS, bool MAZE>
__global__ void __launch_bounds__(BLOCK, 1) quad3d_policy_rollout_kernel(
    const RolloutParams P, const PolicyParams Q, const int* __restrict__ seed_ptr,
    const float* __restrict__ w, int h, const float* __restrict__ rows_in,
    float* __restrict__ rows_out, float* __restrict__ traj, int B, const scg::ObsExt X) {
  extern __shared__ float smem[];
  const scg::LaneGroup g = scg::lane_group<G>(B);
  float* sh = smem + (threadIdx.x / G) * (OBS ? scg::obs_group_row(h, X.obs_dim)
                                              : scg::mlp_group_row(H > 0 ? H : h));
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  const bool store = g.valid && g.gl == 0;
  // The goal rows at a control step (the static goal when stabilizing).
  const auto goal = [&P](float step_f, float* out) { scg::eval_goal(P, step_f, out); };

  scg::EnvRows r;
  scg::load_rows(rows_in, B, g.e, r);
  scg::StepOut o;
  scg::MazeRows<G> m{};
  if (MAZE && P.maze) scg::load_maze<G>(P, rows_in, B, g, m);

  for (int it = 0; it < P.steps; ++it) {
    float obs[scg::NX];
#pragma unroll
    for (int k = 0; k < scg::NX; ++k) obs[k] = r.s[k];

    // -- the actor's and the critic's forward (means and value), the
    // Gaussian sample and its log-prob (fast_policy.py:141-161), the
    // normalized action map.  The observation instance builds the
    // observation row and stores its record rows first.
    const int D = OBS ? X.obs_dim : scg::NX;
    float* rec = traj + static_cast<size_t>(it) * (2 * D + 9) * B + g.e;
    const float step_pre = r.step_f;
    float mean[4], value, act[4], thr[4], logp;
    if constexpr (OBS) {
      scg::obs_policy_step<scg::NX, 4, G>(X, w, h, Q.relu, r.s, step_pre, it, seed, sh, g, g.valid,
                                          rec, B, goal, act, value, logp);
    } else {
      scg::dual_mlp_group<scg::NX, 4, H, G>(w, h, obs, Q.relu, sh, g, mean, value);
      scg::gaussian_sample<scg::NX, 4, H>(w, h, mean, g.e, it, seed, act, logp);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      thr[i] = Q.normalized ? (1.0f + Q.norm_act_scale * scg::clipf(act[i], -1.0f, 1.0f)) * Q.hover_thrust
                            : scg::clipf(act[i], P.a_low, P.a_high);

    // -- shared env step (dynamics, reward, done, statistics, auto-reset;
    // in MAZE the step noise on the thrust thr, the maze and the poses'
    // redraw).
    const scg::ActionTerms a = scg::action_terms(P, thr, act);
    if constexpr (MAZE) {
      scg::env_step_maze<G>(P, r, a, thr, it, seed, o, m, g);
    } else {
      scg::env_step_group<G>(P, r, a, o, g);
    }

    // -- one record column.
    if constexpr (OBS) {
      if (store) {
#pragma unroll
        for (int i = 0; i < 4; ++i) rec[(D + i) * B] = act[i];
        rec[(D + 4) * B] = o.rew;
        rec[(D + 5) * B] = o.done ? 1.0f : 0.0f;
        rec[(D + 6) * B] = o.trunc ? 1.0f : 0.0f;
        rec[(D + 7) * B] = value;
        rec[(D + 8) * B] = logp;
      }
      scg::store_terminal_obs<scg::NX, G>(X, o.s_post, o.trunc, step_pre, g.e, it, seed, g, g.valid,
                                          rec + (D + 9) * B, B, goal);
    } else if (store) {
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
  if (MAZE && g.valid && P.maze) scg::store_maze<G>(P, rows_out, B, g, m);
}

template <int H, int G, bool OBS, bool MAZE>
int launch(const RolloutParams& P, const PolicyParams& Q, const int* sd, const float* wp,
           int h, const float* ri, float* ro, float* tr, int B, int block, int grid, int smem,
           cudaStream_t st, const scg::ObsExt& X) {
  auto kern = quad3d_policy_rollout_kernel<H, G, OBS, MAZE>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<grid, block, smem, st>>>(P, Q, sd, wp, h, ri, ro, tr, B, X);
  return static_cast<int>(cudaGetLastError());
}

// Both entries' checks of the launch plan: `row` floats of shared memory a
// group.
bool plan_ok(int hidden, int B, int group, int block, int grid, int smem, int row) {
  return !(hidden < 1 || hidden > scg::MLP_MAX_H || group != K3_GROUP || block < 32 || block > BLOCK ||
           block % 32 != 0 || static_cast<long long>(grid) * (block / group) < B ||
           smem < (block / group) * row * static_cast<int>(sizeof(float)));
}

}  // namespace

// 2: the entry takes the launch plan (fast_policy.py::launch_plan).  3: and
// quad3d_policy_rollout_maze runs the maze instances.
extern "C" int quad3d_policy_rollout_api_version() { return 3; }

// The size of the observation instances' ObsExt (K3, K6 and K8 take it), for
// the host mirror's check.
extern "C" int obs_ext_params_size() { return static_cast<int>(sizeof(scg::ObsExt)); }

extern "C" int quad3d_policy_rollout(const void* params, int normalized, int relu,
                                     float norm_act_scale, float hover_thrust, int hidden,
                                     const void* seed, const void* wflat, const void* rows_in,
                                     void* rows_out, void* traj, int B, int group, int block,
                                     int grid, int smem, void* stream) {
  if (!plan_ok(hidden, B, group, block, grid, smem, scg::mlp_group_row(hidden)))
    return static_cast<int>(cudaErrorInvalidValue);
  const RolloutParams P = *static_cast<const RolloutParams*>(params);
  const PolicyParams Q{normalized, relu, norm_act_scale, hover_thrust};
  const auto* sd = static_cast<const int*>(seed);
  const auto* wp = static_cast<const float*>(wflat);
  const auto* ri = static_cast<const float*>(rows_in);
  auto* ro = static_cast<float*>(rows_out);
  auto* tr = static_cast<float*>(traj);
  const auto st = static_cast<cudaStream_t>(stream);
  const scg::ObsExt none{};
  return hidden == 64
             ? launch<64, K3_GROUP, false, false>(P, Q, sd, wp, hidden, ri, ro, tr, B, block, grid, smem,
                                                  st, none)
             : launch<0, K3_GROUP, false, false>(P, Q, sd, wp, hidden, ri, ro, tr, B, block, grid, smem,
                                                 st, none);
}

// The observation instance (obs_ext.cuh): ext points to the ObsExt of an
// observation of 12 (1 + goal_blocks) rows, at most 128.
extern "C" int quad3d_policy_rollout_obs(const void* params, const void* ext, int normalized,
                                         int relu, float norm_act_scale, float hover_thrust,
                                         int hidden, const void* seed, const void* wflat,
                                         const void* rows_in, void* rows_out, void* traj, int B,
                                         int group, int block, int grid, int smem, void* stream) {
  const scg::ObsExt X = *static_cast<const scg::ObsExt*>(ext);
  if (X.goal_blocks < 0 || X.obs_dim != scg::NX * (1 + X.goal_blocks) ||
      X.obs_dim > scg::MLP_MAX_OBS ||
      !plan_ok(hidden, B, group, block, grid, smem, scg::obs_group_row(hidden, X.obs_dim)))
    return static_cast<int>(cudaErrorInvalidValue);
  const RolloutParams P = *static_cast<const RolloutParams*>(params);
  const PolicyParams Q{normalized, relu, norm_act_scale, hover_thrust};
  return launch<0, K3_GROUP, true, false>(P, Q, static_cast<const int*>(seed),
                                   static_cast<const float*>(wflat), hidden,
                                   static_cast<const float*>(rows_in), static_cast<float*>(rows_out),
                                   static_cast<float*>(traj), B, block, grid, smem,
                                   static_cast<cudaStream_t>(stream), X);
}

// The maze instances (maze.cuh), for configs with the maze or the step
// noise: params as quad3d_policy_rollout's, its rows (27 + maze rows, B);
// ext null for the state observation (H = 64 or the run-time width) or
// the ObsExt of an observation instance; then the arguments of
// quad3d_policy_rollout after its params.
extern "C" int quad3d_policy_rollout_maze(const void* params, const void* ext, int normalized,
                                          int relu, float norm_act_scale, float hover_thrust,
                                          int hidden, const void* seed, const void* wflat,
                                          const void* rows_in, void* rows_out, void* traj, int B,
                                          int group, int block, int grid, int smem, void* stream) {
  const RolloutParams P = *static_cast<const RolloutParams*>(params);
  if (P.maze && (P.n_gates > scg::MAX_GATES || P.n_obst > scg::MAX_OBSTACLES))
    return static_cast<int>(cudaErrorInvalidValue);
  const scg::ObsExt X = ext ? *static_cast<const scg::ObsExt*>(ext) : scg::ObsExt{};
  const int row = ext ? scg::obs_group_row(hidden, X.obs_dim) : scg::mlp_group_row(hidden);
  if ((ext && (X.goal_blocks < 0 || X.obs_dim != scg::NX * (1 + X.goal_blocks) ||
               X.obs_dim > scg::MLP_MAX_OBS)) ||
      !plan_ok(hidden, B, group, block, grid, smem, row))
    return static_cast<int>(cudaErrorInvalidValue);
  const PolicyParams Q{normalized, relu, norm_act_scale, hover_thrust};
  const auto* sd = static_cast<const int*>(seed);
  const auto* wp = static_cast<const float*>(wflat);
  const auto* ri = static_cast<const float*>(rows_in);
  auto* ro = static_cast<float*>(rows_out);
  auto* tr = static_cast<float*>(traj);
  const auto st = static_cast<cudaStream_t>(stream);
  if (ext) return launch<0, K3_GROUP, true, true>(P, Q, sd, wp, hidden, ri, ro, tr, B, block, grid, smem, st, X);
  return hidden == 64
             ? launch<64, K3_GROUP, false, true>(P, Q, sd, wp, hidden, ri, ro, tr, B, block, grid, smem, st, X)
             : launch<0, K3_GROUP, false, true>(P, Q, sd, wp, hidden, ri, ro, tr, B, block, grid, smem, st, X);
}
