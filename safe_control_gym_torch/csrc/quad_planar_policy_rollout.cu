// K8: policy-in-kernel whole rollout of the 1D or 2D quadrotor, the PPO
// data collection of one train step in one launch.
//
// Replaces safe_control_gym_tpu/parallel/fast_quad_planar.py::
// _policy_rollout_kernel (:677): per control step, the dual actor+critic
// MLP over nu outputs on the nx state rows, a Box-Muller Gaussian sample
// from Philox, its log-prob, the normalized action map, the shared step
// (scg::pq::env_step, also K7's) and one record.  Plain version:
// safe_control_gym_torch/parallel/fast_quad_planar.py::
// planar_policy_rollout_plain.  The observation white noise and the
// goal-horizon observation rows of the TPU kernel are not ported
// (fast_quad_planar.supports refuses them).
//
// Layout: state rows (nx + 13, B) as K7; record (T, 2 nx + nu + 5, B), 19
// rows in 2D and 10 in 1D: obs | act | rew | done | trunc | v | logp |
// terminal obs (post-step state times trunc), batch last so that each store
// coalesces.  Weights: csrc/policy_mlp.cuh's flat layout at OBS = nx.
//
// Design: one thread per env, its rows in registers; the MLP as K3's
// (policy_mlp.cuh).
//
// Bound on an H100: operations.  Per 2D env-step the two forwards are
// 2*(6*2H + 2*H*H + H*(2+1)) flops plus biases and tanh, ~19.6k operations
// with the step at H = 64; at B = 4096 and T = 128 that is ~1.03e10
// operations (0.153 ms at 67 TFLOP/s) against 41 MB of record (12 us at
// 3.35 TB/s).  128 warps on 528 schedulers hide no latency, so a call runs
// far below that bound, as K3 (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "policy_mlp.cuh"
#include "quad_planar.cuh"

namespace {

using scg::pq::PlanarParams;

constexpr int BLOCK = 64;

// H: the hidden width, 64, or 0 for a width h read at run time (1..128).
template <int NX, int NU, int H>
__global__ void __launch_bounds__(BLOCK) quad_planar_policy_rollout_kernel(
    const PlanarParams P, int relu, const int* __restrict__ seed_ptr, const float* __restrict__ w,
    int h, const float* __restrict__ rows_in, float* __restrict__ rows_out, float* __restrict__ traj,
    int B) {
  constexpr int TRAJ_ROWS = 2 * NX + NU + 5;
  constexpr int T_ACT = NX, T_REW = NX + NU, T_DONE = T_REW + 1, T_TRUNC = T_REW + 2;
  constexpr int T_V = T_REW + 3, T_LOGP = T_REW + 4, T_TERM = T_REW + 5;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  scg::pq::Rows<NX> r;
  scg::pq::load_rows<NX>(rows_in, B, e, r);
  scg::pq::StepOut<NX> o;

  for (int it = 0; it < P.steps; ++it) {
    float obs[NX];
#pragma unroll
    for (int k = 0; k < NX; ++k) obs[k] = r.s[k];
    float mean[NU], value, act[NU], thr[NU], logp;
    scg::dual_mlp<NX, NU, H>(w, h, obs, relu, mean, value);
    scg::gaussian_sample<NX, NU, H>(w, h, mean, e, it, seed, act, logp);
#pragma unroll
    for (int i = 0; i < NU; ++i) thr[i] = scg::pq::preprocess(P, act[i]);
    scg::pq::env_step<NX, NU>(P, r, thr, act, e, it, seed, o);

    float* rec = traj + static_cast<size_t>(it) * TRAJ_ROWS * B + e;
#pragma unroll
    for (int k = 0; k < NX; ++k) rec[k * B] = obs[k];
#pragma unroll
    for (int i = 0; i < NU; ++i) rec[(T_ACT + i) * B] = act[i];
    const float truncf = o.trunc ? 1.0f : 0.0f;
    rec[T_REW * B] = o.rew;
    rec[T_DONE * B] = o.done ? 1.0f : 0.0f;
    rec[T_TRUNC * B] = truncf;
    rec[T_V * B] = value;
    rec[T_LOGP * B] = logp;
#pragma unroll
    for (int k = 0; k < NX; ++k) rec[(T_TERM + k) * B] = o.s_post[k] * truncf;
  }
  scg::pq::store_rows<NX>(rows_out, B, e, r);
}

}  // namespace

extern "C" int quad_planar_policy_rollout(const void* params, int nx, int relu, int hidden,
                                          const void* seed, const void* wflat, const void* rows_in,
                                          void* rows_out, void* traj, int B, void* stream) {
  const PlanarParams P = *static_cast<const PlanarParams*>(params);
  if (hidden < 1 || hidden > scg::MLP_MAX_H) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (B + BLOCK - 1) / BLOCK;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sd = static_cast<const int*>(seed);
  const float* wp = static_cast<const float*>(wflat);
  const float* ri = static_cast<const float*>(rows_in);
  float* ro = static_cast<float*>(rows_out);
  float* tr = static_cast<float*>(traj);
  if (nx == 2 && hidden == 64) {
    quad_planar_policy_rollout_kernel<2, 1, 64><<<grid, BLOCK, 0, st>>>(P, relu, sd, wp, hidden, ri,
                                                                      ro, tr, B);
  } else if (nx == 2) {
    quad_planar_policy_rollout_kernel<2, 1, 0><<<grid, BLOCK, 0, st>>>(P, relu, sd, wp, hidden, ri,
                                                                     ro, tr, B);
  } else if (nx == 6 && hidden == 64) {
    quad_planar_policy_rollout_kernel<6, 2, 64><<<grid, BLOCK, 0, st>>>(P, relu, sd, wp, hidden, ri,
                                                                      ro, tr, B);
  } else if (nx == 6) {
    quad_planar_policy_rollout_kernel<6, 2, 0><<<grid, BLOCK, 0, st>>>(P, relu, sd, wp, hidden, ri,
                                                                     ro, tr, B);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
