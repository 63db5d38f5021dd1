// K5: whole constant-action rollout of CartPole, many control steps per
// launch.
//
// Replaces safe_control_gym_tpu/parallel/fast_cartpole.py::_rollout_kernel
// (:264): per control step, the shared step scg::cp::env_step (action white
// noise, impulse, RK4 on the cart-pole ODE, closed-form x-axis reference,
// reward, out-of-bound done and the non-finite freeze, box violations,
// statistics and the counter-PRNG auto-reset).  Plain version:
// safe_control_gym_torch/parallel/fast_cartpole.py::cartpole_rollout_plain.
//
// Layout: state rows (18, B) with row r of env b at r*B + b, at the JAX
// package's row indices; action (1, B).  The TPU's (rows, 8, B/8) tiling is
// dropped: consecutive threads read consecutive addresses of each row.
//
// Design: one thread per env, its 18 rows in registers for the whole call,
// a loop over `steps` in place of the TPU's fori_loop; device memory is
// touched once in and once out per call.  The TPU core PRNG of the action
// noise becomes Philox keyed on (call seed, env) and counted by (step,
// block, call site 1).
//
// Bound on an H100: operations.  An env-step is ~310 operations counting
// each transcendental as one (chip_smoke.py::bounds: one RK4 substep of 4
// cart-pole derivatives, the noise's Philox block and Box-Muller, goal,
// reward, statistics); at B = 4096 and 8192 steps that is ~1.05e10
// operations (0.157 ms at 67 TFLOP/s) against 0.6 MB moved.  B = 4096
// threads are 128 warps, under one per SM, so the dependent chain of each
// thread's step sets the time, as in K2 (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "cartpole.cuh"

namespace {

using scg::cp::CartPoleParams;

__global__ void cartpole_rollout_kernel(const CartPoleParams P, const int* __restrict__ seed_ptr,
                                        const float* __restrict__ rows_in,
                                        const float* __restrict__ action,
                                        float* __restrict__ rows_out, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  scg::cp::Rows r;
  scg::cp::load_rows(rows_in, B, e, r);
  // The action is constant over the call, and so is its preprocessing.
  const float act = action[e];
  const float force = scg::cp::preprocess(P, act);
  scg::cp::StepOut o;
  for (int it = 0; it < P.steps; ++it) scg::cp::env_step(P, r, force, act, e, it, seed, o);
  scg::cp::store_rows(rows_out, B, e, r);
}

}  // namespace

// sizeof(CartPoleParams), checked against the ctypes mirror at launch.
extern "C" int cartpole_params_size() { return static_cast<int>(sizeof(CartPoleParams)); }

extern "C" int cartpole_rollout(const void* params, const void* seed, const void* rows_in,
                                const void* action, void* rows_out, int B, int block,
                                void* stream) {
  const CartPoleParams P = *static_cast<const CartPoleParams*>(params);
  const int grid = (B + block - 1) / block;
  cartpole_rollout_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const int*>(seed), static_cast<const float*>(rows_in),
      static_cast<const float*>(action), static_cast<float*>(rows_out), B);
  return static_cast<int>(cudaGetLastError());
}
