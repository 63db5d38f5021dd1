// K2: whole constant-action rollout of the 3D quadrotor, many control steps
// per launch.
//
// Replaces safe_control_gym_tpu/parallel/fast_env.py::_rollout_kernel (and
// the non-maze path of its step_env_core): per control step, action clip,
// actuation, impulse dynamics force, RK4/Euler substeps, the closed-form
// goal (eval_goal / eval_curve), box-constraint violation, out-of-bound
// done, rl_reward or quadratic reward, goal-capture done, time limit, the
// 7 episode-statistic rows, and the counter-PRNG auto-reset (slot remap of
// fast_env.py:540).
//
// Layout: state rows (27, B) with row r of env b at r*B + b, at the JAX
// package's row indices (fast_env.py:48-57); action (4, B).  The TPU's
// (rows, 8, B/8) tiling is dropped: consecutive threads read consecutive
// addresses of each row, so every load and store coalesces.
//
// Design: one thread per env, all 27 rows in registers for the whole call,
// a loop over `steps` inside the thread in place of the TPU's fori_loop.
// Device memory is touched once in and once out per call.  The step itself
// (scg::env_step) and the row layout live in quad3d.cuh, shared with K3.
//
// Bound on an H100: arithmetic.  At B = 4096 and 8192 steps a call moves
// under 1 MB but does ~2.3k f32 ops and ~135 transcendentals per env-step
// (~77 GFLOP), about 1.2 ms at the card's 67 TFLOP/s f32 peak.  That peak
// needs every SM's four schedulers busy; B = 4096 threads are 128 warps,
// under one warp per SM, so a call runs at a small share of it and the
// dependent chain of each thread's step sets the time.  More envs per
// launch, or several envs per thread for instruction-level parallelism, is
// later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "quad3d.cuh"

namespace {

using scg::RolloutParams;

__global__ void quad3d_rollout_kernel(const RolloutParams P, const float* __restrict__ rows_in,
                                      const float* __restrict__ action, float* __restrict__ rows_out,
                                      int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  scg::EnvRows r;
  scg::load_rows(rows_in, B, e, r);

  // The action is constant over the call: clip, action cost and actuation
  // are the same every step.
  float act[4], thr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    act[i] = action[i * B + e];
    thr[i] = scg::clipf(act[i], P.a_low, P.a_high);
  }
  const scg::ActionTerms a = scg::action_terms(P, thr, act);
  scg::StepOut o;
  for (int it = 0; it < P.steps; ++it) scg::env_step(P, r, a, o);
  scg::store_rows(rows_out, B, e, r);
}

}  // namespace

// sizeof(RolloutParams), checked against the ctypes mirror at load time.
extern "C" int quad3d_rollout_params_size() { return static_cast<int>(sizeof(RolloutParams)); }

extern "C" int quad3d_rollout(const void* params, const void* rows_in, const void* action,
                              void* rows_out, int B, int block, void* stream) {
  const RolloutParams P = *static_cast<const RolloutParams*>(params);
  const int grid = (B + block - 1) / block;
  quad3d_rollout_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const float*>(rows_in), static_cast<const float*>(action),
      static_cast<float*>(rows_out), B);
  return static_cast<int>(cudaGetLastError());
}
