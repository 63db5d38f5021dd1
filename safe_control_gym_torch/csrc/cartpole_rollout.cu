// K5: whole constant-action rollout of CartPole, many control steps per
// launch.
//
// Replaces safe_control_gym_tpu/parallel/fast_cartpole.py::_rollout_kernel
// (:264): per control step, the grouped step scg::grp::cp_step (action
// white noise, impulse, RK4 on the cart-pole ODE, closed-form x-axis
// reference, reward, out-of-bound done and the non-finite freeze, box
// violations, statistics and the counter-PRNG auto-reset), also K6's.  Plain version:
// safe_control_gym_torch/parallel/fast_cartpole.py::cartpole_rollout_plain.
//
// Layout: state rows (18, B) with row r of env b at r*B + b, at the JAX
// package's row indices; action (1, B).  The TPU's (rows, 8, B/8) tiling is
// dropped: consecutive threads read consecutive addresses of each row.
//
// Design: one env over a group of G lanes of a warp
// (csrc/lane_group_planar.cuh::cp_step), its 18 rows in every lane's
// registers for the whole call, a loop over `steps` in place of the TPU's
// fori_loop; device memory is touched once in and once out per call.  The
// TPU core PRNG of the action noise becomes Philox keyed on (call seed, env)
// and counted by (step, block, call site 1).
//
// Bound on an H100: operations.  An env-step is ~310 operations counting
// each transcendental as one (chip_smoke.py::bounds: one RK4 substep of 4
// cart-pole derivatives, the noise's Philox block and Box-Muller, goal,
// reward, statistics); at B = 4096 and 8192 steps that is ~1.05e10
// operations (0.157 ms at 67 TFLOP/s) against 0.6 MB moved.  With one thread
// per env a step was one dependent chain of ~30 convergence regions (each
// accurate sin/cos, sqrt and IEEE division), and 4096 threads were 128 warps
// for 528 warp schedulers.  The group runs a substep's theta chain in 11
// regions, draws the noise of G steps in one round, and makes G times as
// many warps; the launch plan (fast_cartpole.py::launch_plan) takes 4, 2
// or 1 lanes by B, as measured fastest (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "cartpole.cuh"
#include "lane_group_planar.cuh"

namespace {

using scg::cp::CartPoleParams;

constexpr int BLOCK = 128;  // the largest block the launch plan asks for

// At least one block an SM (the bound the kernels were measured with; a
// block-size-only bound spilled in K2, PERF.md).
template <int G>
__global__ void __launch_bounds__(BLOCK, 1) cartpole_rollout_kernel(
    const CartPoleParams P, const int* __restrict__ seed_ptr, const float* __restrict__ rows_in,
    const float* __restrict__ action, float* __restrict__ rows_out, int B) {
  const scg::LaneGroup g = scg::lane_group<G>(B);
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  scg::cp::Rows r;
  scg::cp::load_rows(rows_in, B, g.e, r);
  // The action is constant over the call, and so is its preprocessing.
  const float act = action[g.e];
  const float force = scg::cp::preprocess(P, act);
  float nz = 0.0f;
  scg::cp::StepOut unused;  // K5 records nothing
  for (int it = 0; it < P.steps; ++it)
    scg::grp::cp_step<G>(P, r, force, act, it, seed, nz, g, unused);
  if (g.valid && g.gl == 0) scg::cp::store_rows(rows_out, B, g.e, r);
}

template <int G>
int launch(const CartPoleParams& P, const int* seed, const float* rows_in, const float* action,
           float* rows_out, int B, int block, int grid, cudaStream_t st) {
  cartpole_rollout_kernel<G><<<grid, block, 0, st>>>(P, seed, rows_in, action, rows_out, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sizeof(CartPoleParams), checked against the ctypes mirror at launch.
extern "C" int cartpole_params_size() { return static_cast<int>(sizeof(CartPoleParams)); }

// 2: the entry takes the launch plan (fast_cartpole.py::launch_plan).
extern "C" int cartpole_rollout_api_version() { return 2; }

extern "C" int cartpole_rollout(const void* params, const void* seed, const void* rows_in,
                                const void* action, void* rows_out, int B, int group, int block,
                                int grid, void* stream) {
  if (group < 1 || block < 32 || block > BLOCK || block % 32 != 0 ||
      static_cast<long long>(grid) * (block / group) < B)
    return static_cast<int>(cudaErrorInvalidValue);
  const CartPoleParams P = *static_cast<const CartPoleParams*>(params);
  const int* sd = static_cast<const int*>(seed);
  const float* ri = static_cast<const float*>(rows_in);
  const float* ac = static_cast<const float*>(action);
  float* ro = static_cast<float*>(rows_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The group sizes fast_cartpole.py::launch_plan picks from.
  if (group == 1) return launch<1>(P, sd, ri, ac, ro, B, block, grid, st);
  if (group == 2) return launch<2>(P, sd, ri, ac, ro, B, block, grid, st);
  if (group == 4) return launch<4>(P, sd, ri, ac, ro, B, block, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}


