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
// (rows, 8, B/8) tiling is dropped: consecutive groups read consecutive
// addresses of each row.
//
// Design: one env over a group of K2_GROUP lanes of a warp
// (csrc/lane_group.cuh), all 27 rows in every lane's registers for the
// whole call, a loop over `steps` in place of the TPU's fori_loop.  Device
// memory is touched once in and once out per call.  The group runs each
// rigid-body derivative's six sin/cos calls and six divisions side by side
// (scg::fc_group, shared with K1 and K3) and the rest of the step
// (scg::env_step, shared with K3)
// on identical registers in every lane.
//
// Bound on an H100: arithmetic.  At B = 4096 and 8192 steps a call moves
// under 1 MB but does ~2.3k f32 ops and ~135 transcendentals per env-step
// (~77 GFLOP), about 1.2 ms at the card's 67 TFLOP/s f32 peak.  The call
// runs far below it: with one thread per env a step was one dependent chain
// in which each accurate sin/cos and each IEEE division sits in a region of
// its own (a convergence barrier around its rare slow path), and 4096
// threads were 128 warps for 528 warp schedulers.  The group shortens that
// chain to one sincosf and two rounds of division per derivative and runs
// K2_GROUP times as many warps; what is left is the chain and the
// redundant issue of the rest of the step (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "lane_group.cuh"
#include "quad3d.cuh"

#ifndef K2_GROUP
#define K2_GROUP 4
#endif

namespace {

using scg::RolloutParams;

constexpr int BLOCK = 128;  // the largest block the launch plan asks for

// The launch bound names one block an SM: with the block size alone ptxas
// held the kernel at 96 registers and spilled (PERF.md).
template <int G>
__global__ void __launch_bounds__(BLOCK, 1) quad3d_rollout_kernel(
    const RolloutParams P, const float* __restrict__ rows_in,
    const float* __restrict__ action, float* __restrict__ rows_out, int B) {
  const scg::LaneGroup g = scg::lane_group<G>(B);
  scg::EnvRows r;
  scg::load_rows(rows_in, B, g.e, r);

  // The action is constant over the call: clip, action cost and actuation
  // are the same every step.
  float act[4], thr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    act[i] = action[i * B + g.e];
    thr[i] = scg::clipf(act[i], P.a_low, P.a_high);
  }
  const scg::ActionTerms a = scg::action_terms(P, thr, act);
  scg::StepOut o;
  for (int it = 0; it < P.steps; ++it) scg::env_step_group<G>(P, r, a, o, g);
  if (g.valid && g.gl == 0) scg::store_rows(rows_out, B, g.e, r);
}

}  // namespace

// sizeof(RolloutParams), checked against the ctypes mirror at load time.
extern "C" int quad3d_rollout_params_size() { return static_cast<int>(sizeof(RolloutParams)); }

// 2: the entry takes the launch plan (fast_env.py::launch_plan).
extern "C" int quad3d_rollout_api_version() { return 2; }

extern "C" int quad3d_rollout(const void* params, const void* rows_in, const void* action,
                              void* rows_out, int B, int group, int block, int grid, void* stream) {
  if (group != K2_GROUP || block < 32 || block > BLOCK || block % 32 != 0 ||
      static_cast<long long>(grid) * (block / group) < B)
    return static_cast<int>(cudaErrorInvalidValue);
  const RolloutParams P = *static_cast<const RolloutParams*>(params);
  quad3d_rollout_kernel<K2_GROUP><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const float*>(rows_in), static_cast<const float*>(action),
      static_cast<float*>(rows_out), B);
  return static_cast<int>(cudaGetLastError());
}
