// K6: policy-in-kernel whole rollout of CartPole, the PPO data collection
// of one train step in one launch.
//
// Replaces safe_control_gym_tpu/parallel/fast_cartpole.py::
// _policy_rollout_kernel (:288): per control step, the dual actor+critic
// MLP on the 4 state rows (obs 4 -> 2H -> 2H -> mean, value), a Box-Muller
// Gaussian sample from Philox, its log-prob, the normalized action map, the
// grouped step (scg::grp::cp_step, also K5's) and one record of the
// trajectory.  Plain version: safe_control_gym_torch/parallel/
// fast_cartpole.py::cartpole_policy_rollout_plain.  The observation white
// noise of the TPU kernel runs in the observation instance (obs_ext.cuh,
// 8 lanes an env, the 4 noisy rows in shared memory).
//
// Layout: state rows (18, B) as K5; record (T, 14, B), row r of step t and
// env e at (t*14 + r)*B + e: obs 0..3 | act 4 | rew 5 | done 6 | trunc 7 |
// v 8 | logp 9 | terminal obs 10..13 (post-step state times trunc), the JAX
// record rows (fast_cartpole.py:636-641) with the batch last so that each
// store coalesces.  Weights: csrc/policy_mlp.cuh's flat layout at OBS = 4.
//
// Design: one env over a group of G lanes of a warp, as K3
// (quad3d_policy_rollout.cu), its 18 rows in every lane's registers for the
// whole call.  The dual MLP splits over the group
// (lane_group.cuh::dual_mlp_group, each group with its row of shared
// memory; one lane an env runs policy_mlp.cuh::dual_mlp in registers), the
// sample and the action map run on every lane alike, the step is K5's
// grouped one with its record (grp::cp_step<G, true>), and the group's lane
// 0 stores the record.  The launch plan
// (fast_cartpole.py::policy_launch_plan) takes 8 lanes up to B = 16384 and
// one above (PERF.md).  The TPU's double-buffered record DMA is not needed:
// a store does not stall the thread.
//
// Bound on an H100: operations.  Per env-step the two forwards are
// 2*(4*2H + 2*H*H + H*(1+1)) flops plus biases and tanh, ~18.5k operations
// with the step at H = 64; at B = 4096 and T = 128 that is ~9.7e9
// operations (0.145 ms at 67 TFLOP/s) against 30 MB of record (9 us at
// 3.35 TB/s).  One thread per env made 128 warps for 528 schedulers, each
// running the MLP as one serial chain; the group makes G times as many
// warps, each lane with 1/G of the MLP's sums (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "cartpole.cuh"
#include "lane_group.cuh"
#include "lane_group_planar.cuh"
#include "obs_ext.cuh"
#include "policy_mlp.cuh"

namespace {

using scg::cp::CartPoleParams;

constexpr int OBS = scg::cp::NX, NU = 1;
constexpr int TRAJ_ROWS = 2 * OBS + NU + 5;
constexpr int T_ACT = OBS, T_REW = OBS + NU, T_DONE = T_REW + 1, T_TRUNC = T_REW + 2;
constexpr int T_V = T_REW + 3, T_LOGP = T_REW + 4, T_TERM = T_REW + 5;

// H: the hidden width, 64, or 0 for a width h read at run time (1..128).
// G: lanes per env, 8 or 1.  The launch bound names a block of 32 envs:
// at 8 lanes one block an SM, as K3's; at one lane an env 16 blocks an SM,
// which holds a thread to 128 registers, so that B = 65536 runs in one wave
// as the one-thread kernel did (at 162 registers K6 was 1.34x slower there;
// at 128 its H = 64 instance keeps three statistics rows in local memory,
// 28 bytes, and runs at the one-thread kernel's time: PERF.md).  NOISE: the
// observation instance (obs_ext.cuh; H = 0, G = 8) of a config with
// observation white noise, its observation X; the other instances never
// read X.
template <int H, int G, bool NOISE>
__global__ void __launch_bounds__(32 * G, G == 1 ? 16 : 1) cartpole_policy_rollout_kernel(
    const CartPoleParams P, int relu, const int* __restrict__ seed_ptr, const float* __restrict__ w,
    int h, const float* __restrict__ rows_in, float* __restrict__ rows_out, float* __restrict__ traj,
    int B, const scg::ObsExt X) {
  extern __shared__ float smem[];
  const scg::LaneGroup g = scg::lane_group<G>(B);
  float* sh = smem + (threadIdx.x / G) * (NOISE ? scg::obs_group_row(h, OBS)
                                                : scg::mlp_group_row(H > 0 ? H : h));
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  const bool store = g.valid && g.gl == 0;
  const auto no_goal = [](float, float*) {};  // CartPole's observation has no goal rows
  scg::cp::Rows r;
  scg::cp::load_rows(rows_in, B, g.e, r);
  scg::cp::StepOut o;
  float nz = 0.0f;

  for (int it = 0; it < P.steps; ++it) {
    float mean[NU], value, act[NU], logp;
    const float step_pre = r.step_f;
    if constexpr (NOISE) {
      float* rec = traj + static_cast<size_t>(it) * TRAJ_ROWS * B + g.e;
      scg::obs_policy_step<OBS, NU, G>(X, w, h, relu, r.s, step_pre, it, seed, sh, g, g.valid, rec,
                                       B, no_goal, act, value, logp);
      if (store) {
        rec[T_ACT * B] = act[0];
        rec[T_V * B] = value;
        rec[T_LOGP * B] = logp;
      }
    } else {
      if constexpr (G == 1) {
        scg::dual_mlp<OBS, NU, H>(w, h, r.s, relu, mean, value);  // in registers, no row
      } else {
        scg::dual_mlp_group<OBS, NU, H, G>(w, h, r.s, relu, sh, g, mean, value);
      }
      scg::gaussian_sample<OBS, NU, H>(w, h, mean, g.e, it, seed, act, logp);
      // The record's rows known before the step (the observation is the
      // state the step starts from) are stored before it, so that they hold
      // no registers across it.
      if (store) {
        float* rec = traj + static_cast<size_t>(it) * TRAJ_ROWS * B + g.e;
#pragma unroll
        for (int k = 0; k < OBS; ++k) rec[k * B] = r.s[k];
        rec[T_ACT * B] = act[0];
        rec[T_V * B] = value;
        rec[T_LOGP * B] = logp;
      }
    }
    scg::grp::cp_step<G, true>(P, r, scg::cp::preprocess(P, act[0]), act[0], it, seed, nz, g, o);
    if (store) {
      float* rec = traj + static_cast<size_t>(it) * TRAJ_ROWS * B + g.e;
      const float truncf = o.trunc ? 1.0f : 0.0f;
      rec[T_REW * B] = o.rew;
      rec[T_DONE * B] = o.done ? 1.0f : 0.0f;
      rec[T_TRUNC * B] = truncf;
      if constexpr (!NOISE) {
#pragma unroll
        for (int k = 0; k < OBS; ++k) rec[(T_TERM + k) * B] = o.s_post[k] * truncf;
      }
    }
    if constexpr (NOISE) {
      scg::store_terminal_obs<OBS, G>(X, o.s_post, o.trunc, step_pre, g.e, it, seed, g, g.valid,
                                      traj + (static_cast<size_t>(it) * TRAJ_ROWS + T_TERM) * B + g.e,
                                      B, no_goal);
    }
  }
  if (store) scg::cp::store_rows(rows_out, B, g.e, r);
}

// One launch's arguments, in the kernel's order.
struct Args {
  CartPoleParams P;
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

template <int H, int G, bool NOISE = false>
int launch(const Args& a, int block, int grid, int smem, cudaStream_t st) {
  auto kern = cartpole_policy_rollout_kernel<H, G, NOISE>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<grid, block, smem, st>>>(a.P, a.relu, a.sd, a.wp, a.h, a.ri, a.ro, a.tr, a.B, a.X);
  return static_cast<int>(cudaGetLastError());
}

// The instance of width a.h (64 has its own) and G lanes per env.
template <int G>
int launch_width(const Args& a, int block, int grid, int smem, cudaStream_t st) {
  return a.h == 64 ? launch<64, G>(a, block, grid, smem, st)
                   : launch<0, G>(a, block, grid, smem, st);
}

// The plan's checks: the block is 32 envs (the launch bounds), each group
// of 8 lanes with its row of `row` floats of shared memory.
bool plan_ok(int hidden, int B, int group, int block, int grid, int smem, int row) {
  return !(hidden < 1 || hidden > scg::MLP_MAX_H || block != 32 * group ||
           static_cast<long long>(grid) * 32 < B ||
           smem < (group > 1 ? 32 * row : 0) * static_cast<int>(sizeof(float)));
}

}  // namespace

// 2: the entry takes the launch plan (fast_cartpole.py::policy_launch_plan).
extern "C" int cartpole_policy_rollout_api_version() { return 2; }

extern "C" int cartpole_policy_rollout(const void* params, int relu, int hidden, const void* seed,
                                       const void* wflat, const void* rows_in, void* rows_out,
                                       void* traj, int B, int group, int block, int grid, int smem,
                                       void* stream) {
  if (!plan_ok(hidden, B, group, block, grid, smem, scg::mlp_group_row(hidden)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{*static_cast<const CartPoleParams*>(params), relu, static_cast<const int*>(seed),
               static_cast<const float*>(wflat), hidden, static_cast<const float*>(rows_in),
               static_cast<float*>(rows_out), static_cast<float*>(traj), B, scg::ObsExt{}};
  const auto st = static_cast<cudaStream_t>(stream);
  // The group sizes fast_cartpole.py::policy_launch_plan picks from.
  if (group == 1) return launch_width<1>(a, block, grid, smem, st);
  if (group == 8) return launch_width<8>(a, block, grid, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The observation instance (obs_ext.cuh, 8 lanes an env): ext points to
// the ObsExt of the 4 state rows with observation white noise.
extern "C" int cartpole_policy_rollout_obs(const void* params, const void* ext, int relu, int hidden,
                                           const void* seed, const void* wflat, const void* rows_in,
                                           void* rows_out, void* traj, int B, int group, int block,
                                           int grid, int smem, void* stream) {
  const scg::ObsExt X = *static_cast<const scg::ObsExt*>(ext);
  if (X.obs_dim != OBS || X.goal_blocks != 0 || group != 8 ||
      !plan_ok(hidden, B, group, block, grid, smem, scg::obs_group_row(hidden, OBS)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{*static_cast<const CartPoleParams*>(params), relu, static_cast<const int*>(seed),
               static_cast<const float*>(wflat), hidden, static_cast<const float*>(rows_in),
               static_cast<float*>(rows_out), static_cast<float*>(traj), B, X};
  return launch<0, 8, true>(a, block, grid, smem, static_cast<cudaStream_t>(stream));
}
