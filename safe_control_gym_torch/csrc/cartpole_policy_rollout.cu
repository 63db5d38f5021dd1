// K6: policy-in-kernel whole rollout of CartPole, the PPO data collection
// of one train step in one launch.
//
// Replaces safe_control_gym_tpu/parallel/fast_cartpole.py::
// _policy_rollout_kernel (:288): per control step, the dual actor+critic
// MLP on the 4 state rows (obs 4 -> 2H -> 2H -> mean, value), a Box-Muller
// Gaussian sample from Philox, its log-prob, the normalized action map, the
// shared step (scg::cp::env_step, also K5's) and one record of the
// trajectory.  Plain version: safe_control_gym_torch/parallel/
// fast_cartpole.py::cartpole_policy_rollout_plain.  The observation white
// noise of the TPU kernel is not ported (fast_cartpole.supports refuses it).
//
// Layout: state rows (18, B) as K5; record (T, 14, B), row r of step t and
// env e at (t*14 + r)*B + e: obs 0..3 | act 4 | rew 5 | done 6 | trunc 7 |
// v 8 | logp 9 | terminal obs 10..13 (post-step state times trunc), the JAX
// record rows (fast_cartpole.py:636-641) with the batch last so that each
// store coalesces.  Weights: csrc/policy_mlp.cuh's flat layout at OBS = 4.
//
// Design: one thread per env, its rows in registers for the whole call; the
// MLP as K3's (policy_mlp.cuh).  The TPU's double-buffered record DMA is not
// needed: a store does not stall the thread.
//
// Bound on an H100: operations.  Per env-step the two forwards are
// 2*(4*2H + 2*H*H + H*(1+1)) flops plus biases and tanh, ~18.5k operations
// with the step at H = 64; at B = 4096 and T = 128 that is ~9.7e9
// operations (0.145 ms at 67 TFLOP/s) against 30 MB of record (9 us at
// 3.35 TB/s).  128 warps on 528 schedulers hide no latency, so a call runs
// far below that bound, as K3 (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "cartpole.cuh"
#include "policy_mlp.cuh"

namespace {

using scg::cp::CartPoleParams;

constexpr int OBS = scg::cp::NX, NU = 1;
constexpr int TRAJ_ROWS = 2 * OBS + NU + 5;
constexpr int T_ACT = OBS, T_REW = OBS + NU, T_DONE = T_REW + 1, T_TRUNC = T_REW + 2;
constexpr int T_V = T_REW + 3, T_LOGP = T_REW + 4, T_TERM = T_REW + 5;
constexpr int BLOCK = 64;

// H: the hidden width, 64, or 0 for a width h read at run time (1..128).
template <int H>
__global__ void __launch_bounds__(BLOCK) cartpole_policy_rollout_kernel(
    const CartPoleParams P, int relu, const int* __restrict__ seed_ptr, const float* __restrict__ w,
    int h, const float* __restrict__ rows_in, float* __restrict__ rows_out, float* __restrict__ traj,
    int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  scg::cp::Rows r;
  scg::cp::load_rows(rows_in, B, e, r);
  scg::cp::StepOut o;

  for (int it = 0; it < P.steps; ++it) {
    float obs[OBS];
#pragma unroll
    for (int k = 0; k < OBS; ++k) obs[k] = r.s[k];
    float mean[NU], value, act[NU], logp;
    scg::dual_mlp<OBS, NU, H>(w, h, obs, relu, mean, value);
    scg::gaussian_sample<OBS, NU, H>(w, h, mean, e, it, seed, act, logp);
    scg::cp::env_step(P, r, scg::cp::preprocess(P, act[0]), act[0], e, it, seed, o);

    float* rec = traj + static_cast<size_t>(it) * TRAJ_ROWS * B + e;
#pragma unroll
    for (int k = 0; k < OBS; ++k) rec[k * B] = obs[k];
    rec[T_ACT * B] = act[0];
    const float truncf = o.trunc ? 1.0f : 0.0f;
    rec[T_REW * B] = o.rew;
    rec[T_DONE * B] = o.done ? 1.0f : 0.0f;
    rec[T_TRUNC * B] = truncf;
    rec[T_V * B] = value;
    rec[T_LOGP * B] = logp;
#pragma unroll
    for (int k = 0; k < OBS; ++k) rec[(T_TERM + k) * B] = o.s_post[k] * truncf;
  }
  scg::cp::store_rows(rows_out, B, e, r);
}

}  // namespace

extern "C" int cartpole_policy_rollout(const void* params, int relu, int hidden, const void* seed,
                                       const void* wflat, const void* rows_in, void* rows_out,
                                       void* traj, int B, void* stream) {
  const CartPoleParams P = *static_cast<const CartPoleParams*>(params);
  if (hidden < 1 || hidden > scg::MLP_MAX_H) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (B + BLOCK - 1) / BLOCK;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sd = static_cast<const int*>(seed);
  const float* wp = static_cast<const float*>(wflat);
  const float* ri = static_cast<const float*>(rows_in);
  float* ro = static_cast<float*>(rows_out);
  float* tr = static_cast<float*>(traj);
  if (hidden == 64) {
    cartpole_policy_rollout_kernel<64><<<grid, BLOCK, 0, st>>>(P, relu, sd, wp, hidden, ri, ro, tr,
                                                               B);
  } else {
    cartpole_policy_rollout_kernel<0><<<grid, BLOCK, 0, st>>>(P, relu, sd, wp, hidden, ri, ro, tr,
                                                              B);
  }
  return static_cast<int>(cudaGetLastError());
}
