// K2: whole constant-action rollout of the 3D quadrotor, many control steps
// per launch.
//
// Replaces safe_control_gym_tpu/parallel/fast_env.py::_rollout_kernel and
// its step_env_core: per control step, action clip, action white noise,
// actuation, impulse or uniform dynamics force, RK4/Euler substeps, the
// closed-form goal (eval_goal / eval_curve), the competition maze's
// geometry (gates, obstacles, ground; gate progress and completion), box-
// constraint violation, out-of-bound, collision and completion done,
// rl_reward, quadratic or competition reward, goal-capture done, time
// limit, the 7 episode-statistic rows, and the counter-PRNG auto-reset
// (slot remap of fast_env.py:540) with the maze's pose redraws.
//
// Layout: state rows (27 + maze rows, B) with row r of env b at r*B + b, at
// the JAX package's row indices (fast_env.py:48-57, :839-846); action (4,
// B).  The TPU's (rows, 8, B/8) tiling is dropped: consecutive groups read
// consecutive addresses of each row.  The TPU core PRNG of the step noise
// becomes Philox keyed on (call seed, env, step, call site) (philox.cuh).
//
// Design: one env over a group of K2_GROUP lanes of a warp
// (csrc/lane_group.cuh), all 27 rows in every lane's registers for the
// whole call, a loop over `steps` in place of the TPU's fori_loop.  Device
// memory is touched once in and once out per call.  The group runs each
// rigid-body derivative's six sin/cos calls and six divisions side by side
// (scg::fc_group, shared with K1 and K3) and the rest of the step
// (scg::env_step, shared with K3) on identical registers in every lane.
// Two instances: configs without the maze and the step noise (config 4)
// run the one K3's step shares; the others run the maze instance
// (csrc/maze.cuh: the lanes split the gates and obstacles and the four
// motors' noisy actuation), whose branch the first compiles out.
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
#include "maze.cuh"
#include "quad3d.cuh"

#ifndef K2_GROUP
#define K2_GROUP 4
#endif

namespace {

using scg::RolloutParams;

constexpr int BLOCK = 128;  // the largest block the launch plan asks for

// The launch bound names one block an SM: with the block size alone ptxas
// held the kernel at 96 registers and spilled (PERF.md).  MAZE: the maze
// instance (the maze and the step noise; csrc/maze.cuh).
template <int G, bool MAZE>
__global__ void __launch_bounds__(BLOCK, 1) quad3d_rollout_kernel(
    const RolloutParams P, const int* __restrict__ seed_ptr, const float* __restrict__ rows_in,
    const float* __restrict__ action, float* __restrict__ rows_out, int B) {
  const scg::LaneGroup g = scg::lane_group<G>(B);
  scg::EnvRows r;
  scg::load_rows(rows_in, B, g.e, r);

  // The action is constant over the call: clip, action cost and (without
  // action noise) actuation are the same every step.
  float act[4], thr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    act[i] = action[i * B + g.e];
    thr[i] = scg::clipf(act[i], P.a_low, P.a_high);
  }
  const scg::ActionTerms a = scg::action_terms(P, thr, act);
  scg::StepOut o;
  if constexpr (MAZE) {
    const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
    scg::MazeRows<G> m{};
    if (P.maze) scg::load_maze<G>(P, rows_in, B, g, m);
    for (int it = 0; it < P.steps; ++it) scg::env_step_maze<G>(P, r, a, thr, it, seed, o, m, g);
    if (g.valid && P.maze) scg::store_maze<G>(P, rows_out, B, g, m);
  } else {
    for (int it = 0; it < P.steps; ++it) scg::env_step_group<G>(P, r, a, o, g);
  }
  if (g.valid && g.gl == 0) scg::store_rows(rows_out, B, g.e, r);
}

}  // namespace

// sizeof(RolloutParams), checked against the ctypes mirror at load time.
extern "C" int quad3d_rollout_params_size() { return static_cast<int>(sizeof(RolloutParams)); }

// 2: the entry takes the launch plan (fast_env.py::launch_plan).  3: and the
// call seed, and runs the maze instance where the config has the maze or
// step noise.
extern "C" int quad3d_rollout_api_version() { return 3; }

extern "C" int quad3d_rollout(const void* params, const void* seed, const void* rows_in,
                              const void* action, void* rows_out, int B, int group, int block,
                              int grid, void* stream) {
  if (group != K2_GROUP || block < 32 || block > BLOCK || block % 32 != 0 ||
      static_cast<long long>(grid) * (block / group) < B)
    return static_cast<int>(cudaErrorInvalidValue);
  const RolloutParams P = *static_cast<const RolloutParams*>(params);
  if (P.maze && (P.n_gates > scg::MAX_GATES || P.n_obst > scg::MAX_OBSTACLES))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sd = static_cast<const int*>(seed);
  const float* in = static_cast<const float*>(rows_in);
  const float* act = static_cast<const float*>(action);
  float* out = static_cast<float*>(rows_out);
  if (P.maze || P.act_noise || P.dyn_uniform)
    quad3d_rollout_kernel<K2_GROUP, true><<<grid, block, 0, st>>>(P, sd, in, act, out, B);
  else
    quad3d_rollout_kernel<K2_GROUP, false><<<grid, block, 0, st>>>(P, sd, in, act, out, B);
  return static_cast<int>(cudaGetLastError());
}
