// K8: policy-in-kernel whole rollout of the 1D or 2D quadrotor, the PPO
// data collection of one train step in one launch.
//
// Replaces safe_control_gym_tpu/parallel/fast_quad_planar.py::
// _policy_rollout_kernel (:677): per control step, the dual actor+critic
// MLP over nu outputs on the nx state rows, a Box-Muller Gaussian sample
// from Philox, its log-prob, the normalized action map, the grouped step
// (scg::grp::pq_step, also K7's) and one record.  Plain version:
// safe_control_gym_torch/parallel/fast_quad_planar.py::
// planar_policy_rollout_plain.  The observation white noise and the
// goal-horizon observation rows of the TPU kernel run in the observation
// instances (obs_ext.cuh, 8 lanes an env, the observation of D = nx (1 +
// goal blocks) rows in shared memory).
//
// Layout: state rows (nx + 13, B) as K7; record (T, 2 D + nu + 5, B), 19
// rows in 2D and 10 in 1D without goal rows (D = nx): obs | act | rew | done
// | trunc | v | logp | terminal obs (the post-step observation times
// trunc), batch last so that each store coalesces.  Weights:
// csrc/policy_mlp.cuh's flat layout at OBS = D.
//
// Design: one env over a group of G lanes of a warp, as K3 and K6, its rows
// in every lane's registers.  The dual MLP splits over the group
// (lane_group.cuh::dual_mlp_group); the step is K7's grouped one under a
// command that changes every step (grp::pq_step<NX, NU, G, true>: the
// action-noise terms of G / NU steps drawn in one round, each step's
// thrusts actuated one input a lane and its body made anew); the group's
// lane 0 stores the record.  One lane an env runs policy_mlp.cuh::dual_mlp
// in registers.  The launch plan (fast_quad_planar.py::policy_launch_plan)
// takes 8 lanes up to B = 16384 and one above (PERF.md).
//
// Bound on an H100: operations.  Per 2D env-step the two forwards are
// 2*(6*2H + 2*H*H + H*(2+1)) flops plus biases and tanh, ~19.6k operations
// with the step at H = 64; at B = 4096 and T = 128 that is ~1.03e10
// operations (0.153 ms at 67 TFLOP/s) against 41 MB of record (12 us at
// 3.35 TB/s).  One thread per env made 128 warps for 528 schedulers, each
// running the MLP as one serial chain; the group makes G times as many
// warps, each lane with 1/G of the MLP's sums (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "lane_group.cuh"
#include "lane_group_planar.cuh"
#include "obs_ext.cuh"
#include "policy_mlp.cuh"
#include "quad_planar.cuh"

namespace {

using scg::pq::PlanarParams;

// H: the hidden width, 64, or 0 for a width h read at run time (1..128).
// G: lanes per env, 8 or 1.  The launch bound names a block of 32 envs:
// at 8 lanes one block an SM, as K3's; at one lane an env 16 blocks an SM,
// which holds a thread to 128 registers, so that B = 65536 runs in one wave
// as the one-thread kernel did (at 158 registers the 1D quad's was 1.37x
// slower there, PERF.md).  OBS: the observation instance (obs_ext.cuh;
// H = 0, G = 8), its observation X of D = X.obs_dim rows; the other
// instances (D = NX) never read X.
template <int NX, int NU, int H, int G, bool OBS>
__global__ void __launch_bounds__(32 * G, G == 1 ? 16 : 1) quad_planar_policy_rollout_kernel(
    const PlanarParams P, int relu, const int* __restrict__ seed_ptr, const float* __restrict__ w,
    int h, const float* __restrict__ rows_in, float* __restrict__ rows_out, float* __restrict__ traj,
    int B, const scg::ObsExt X) {
  const int D = OBS ? X.obs_dim : NX;
  const int TRAJ_ROWS = 2 * D + NU + 5;
  const int T_ACT = D, T_REW = D + NU, T_DONE = T_REW + 1, T_TRUNC = T_REW + 2;
  const int T_V = T_REW + 3, T_LOGP = T_REW + 4, T_TERM = T_REW + 5;
  extern __shared__ float smem[];
  const scg::LaneGroup g = scg::lane_group<G>(B);
  float* sh = smem + (threadIdx.x / G) * (OBS ? scg::obs_group_row(h, D)
                                              : scg::mlp_group_row(H > 0 ? H : h));
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  const bool store = g.valid && g.gl == 0;
  // The goal rows at a control step (the static goal when stabilizing).
  const auto goal = [&P](float step_f, float* out) { scg::grp::planar_goal<NX>(P, step_f, out); };
  scg::pq::Rows<NX> r;
  scg::pq::load_rows<NX>(rows_in, B, g.e, r);
  scg::pq::StepOut<NX> o;
  scg::grp::ForceSlots<NU, G> fs;  // the action-noise terms of the current steps
  scg::grp::PlanarBody b{};

  for (int it = 0; it < P.steps; ++it) {
    float mean[NU], value, act[NU], thr[NU], logp;
    const float step_pre = r.step_f;
    if constexpr (OBS) {
      scg::obs_policy_step<NX, NU, G>(X, w, h, relu, r.s, step_pre, it, seed, sh, g, g.valid,
                                      traj + static_cast<size_t>(it) * TRAJ_ROWS * B + g.e, B, goal,
                                      act, value, logp);
    } else {
      if constexpr (G == 1) {
        scg::dual_mlp<NX, NU, H>(w, h, r.s, relu, mean, value);  // in registers, no row
      } else {
        scg::dual_mlp_group<NX, NU, H, G>(w, h, r.s, relu, sh, g, mean, value);
      }
      scg::gaussian_sample<NX, NU, H>(w, h, mean, g.e, it, seed, act, logp);
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) thr[i] = scg::pq::preprocess(P, act[i]);
    // The record's rows known before the step (the observation is the state
    // the step starts from; the observation instance stored it above) are
    // stored before it, so that they hold no registers across it.
    if (store) {
      float* rec = traj + static_cast<size_t>(it) * TRAJ_ROWS * B + g.e;
      if constexpr (!OBS) {
#pragma unroll
        for (int k = 0; k < NX; ++k) rec[k * B] = r.s[k];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) rec[(T_ACT + i) * B] = act[i];
      rec[T_V * B] = value;
      rec[T_LOGP * B] = logp;
    }
    scg::grp::pq_step<NX, NU, G, true>(P, r, thr, act, it, seed, fs, true, b, g, o);
    if (store) {
      float* rec = traj + static_cast<size_t>(it) * TRAJ_ROWS * B + g.e;
      const float truncf = o.trunc ? 1.0f : 0.0f;
      rec[T_REW * B] = o.rew;
      rec[T_DONE * B] = o.done ? 1.0f : 0.0f;
      rec[T_TRUNC * B] = truncf;
      if constexpr (!OBS) {
#pragma unroll
        for (int k = 0; k < NX; ++k) rec[(T_TERM + k) * B] = o.s_post[k] * truncf;
      }
    }
    if constexpr (OBS) {
      scg::store_terminal_obs<NX, G>(X, o.s_post, o.trunc, step_pre, g.e, it, seed, g, g.valid,
                                     traj + (static_cast<size_t>(it) * TRAJ_ROWS + T_TERM) * B + g.e,
                                     B, goal);
    }
  }
  if (store) scg::pq::store_rows<NX>(rows_out, B, g.e, r);
}

// One launch's arguments, in the kernel's order.
struct Args {
  PlanarParams P;
  int relu;
  const int* sd;
  const float* wp;
  int h;
  const float* ri;
  float* ro;
  float* tr;
  int B;
  scg::ObsExt X;
};

template <int NX, int NU, int H, int G, bool OBS = false>
int launch(const Args& a, int block, int grid, int smem, cudaStream_t st) {
  auto kern = quad_planar_policy_rollout_kernel<NX, NU, H, G, OBS>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<grid, block, smem, st>>>(a.P, a.relu, a.sd, a.wp, a.h, a.ri, a.ro, a.tr, a.B, a.X);
  return static_cast<int>(cudaGetLastError());
}

// The plan's checks: the block is 32 envs (the launch bounds), each group
// of 8 lanes with its row of `row` floats of shared memory.
bool plan_ok(int hidden, int B, int group, int block, int grid, int smem, int row) {
  return !(hidden < 1 || hidden > scg::MLP_MAX_H || block != 32 * group ||
           static_cast<long long>(grid) * 32 < B ||
           smem < (group > 1 ? 32 * row : 0) * static_cast<int>(sizeof(float)));
}

// The instance of the quad type (NX, NU), width a.h (64 has its own) and
// G lanes per env.
template <int NX, int NU, int G>
int launch_width(const Args& a, int block, int grid, int smem, cudaStream_t st) {
  return a.h == 64 ? launch<NX, NU, 64, G>(a, block, grid, smem, st)
                   : launch<NX, NU, 0, G>(a, block, grid, smem, st);
}

}  // namespace

// 2: the entry takes the launch plan (fast_quad_planar.py::policy_launch_plan).
extern "C" int quad_planar_policy_rollout_api_version() { return 2; }

extern "C" int quad_planar_policy_rollout(const void* params, int nx, int relu, int hidden,
                                          const void* seed, const void* wflat, const void* rows_in,
                                          void* rows_out, void* traj, int B, int group, int block,
                                          int grid, int smem, void* stream) {
  if (!plan_ok(hidden, B, group, block, grid, smem, scg::mlp_group_row(hidden)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{*static_cast<const PlanarParams*>(params), relu, static_cast<const int*>(seed),
               static_cast<const float*>(wflat), hidden, static_cast<const float*>(rows_in),
               static_cast<float*>(rows_out), static_cast<float*>(traj), B, scg::ObsExt{}};
  const auto st = static_cast<cudaStream_t>(stream);
  // The group sizes fast_quad_planar.py::policy_launch_plan picks from.
  if (nx == 2 && group == 1) return launch_width<2, 1, 1>(a, block, grid, smem, st);
  if (nx == 2 && group == 8) return launch_width<2, 1, 8>(a, block, grid, smem, st);
  if (nx == 6 && group == 1) return launch_width<6, 2, 1>(a, block, grid, smem, st);
  if (nx == 6 && group == 8) return launch_width<6, 2, 8>(a, block, grid, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The observation instances (obs_ext.cuh, 8 lanes an env): ext points to the
// ObsExt of an observation of nx (1 + goal_blocks) rows, at most 128.
extern "C" int quad_planar_policy_rollout_obs(const void* params, const void* ext, int nx, int relu,
                                              int hidden, const void* seed, const void* wflat,
                                              const void* rows_in, void* rows_out, void* traj, int B,
                                              int group, int block, int grid, int smem, void* stream) {
  const scg::ObsExt X = *static_cast<const scg::ObsExt*>(ext);
  if (X.goal_blocks < 0 || X.obs_dim != nx * (1 + X.goal_blocks) || X.obs_dim > scg::MLP_MAX_OBS ||
      group != 8 || !plan_ok(hidden, B, group, block, grid, smem, scg::obs_group_row(hidden, X.obs_dim)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{*static_cast<const PlanarParams*>(params), relu, static_cast<const int*>(seed),
               static_cast<const float*>(wflat), hidden, static_cast<const float*>(rows_in),
               static_cast<float*>(rows_out), static_cast<float*>(traj), B, X};
  const auto st = static_cast<cudaStream_t>(stream);
  if (nx == 2) return launch<2, 1, 0, 8, true>(a, block, grid, smem, st);
  if (nx == 6) return launch<6, 2, 0, 8, true>(a, block, grid, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
