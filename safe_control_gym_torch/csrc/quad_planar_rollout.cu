// K7: whole constant-action rollout of the 1D or 2D quadrotor, many control
// steps per launch.
//
// Replaces safe_control_gym_tpu/parallel/fast_quad_planar.py::_rollout_kernel
// (:339): per control step, the shared step scg::pq::env_step (action white
// noise, motor-grouped actuation, impulse, RK4 or Euler substeps of
// quad_fc_1d / quad_fc_2d, closed-form goal, reward, out-of-bound done and
// the non-finite freeze, box violations, statistics and the counter-PRNG
// auto-reset over slots 0..4+nx).  Plain version:
// safe_control_gym_torch/parallel/fast_quad_planar.py::planar_rollout_plain.
//
// Layout: state rows (nx + 13, B) = (15, B) or (19, B), row r of env b at
// r*B + b; action (nu, B).  One template on NX/NU serves both quad types.
//
// Design: one thread per env, its rows in registers for the whole call, a
// loop over `steps` in place of the TPU's fori_loop; device memory is
// touched once in and once out per call.
//
// Bound on an H100: operations.  A 2D env-step at 4 RK4 substeps is ~610
// operations counting each transcendental as one (chip_smoke.py::bounds:
// 16 derivatives of a sine, a cosine and 9 operations, 2 actuations,
// reward, statistics); at B = 4096 and 4096 steps that is ~1.03e10
// operations (0.153 ms at 67 TFLOP/s) against 0.66 MB moved.  128 warps on
// 132 SMs leave the dependent chain of each step in charge, as in K2.
#include <cuda_runtime.h>

#include <cstdint>

#include "quad_planar.cuh"

namespace {

using scg::pq::PlanarParams;

template <int NX, int NU>
__global__ void quad_planar_rollout_kernel(const PlanarParams P, const int* __restrict__ seed_ptr,
                                           const float* __restrict__ rows_in,
                                           const float* __restrict__ action,
                                           float* __restrict__ rows_out, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  scg::pq::Rows<NX> r;
  scg::pq::load_rows<NX>(rows_in, B, e, r);
  // The action is constant over the call, and so is its preprocessing.
  float act[NU], thr[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    act[i] = action[i * B + e];
    thr[i] = scg::pq::preprocess(P, act[i]);
  }
  scg::pq::StepOut<NX> o;
  for (int it = 0; it < P.steps; ++it) scg::pq::env_step<NX, NU>(P, r, thr, act, e, it, seed, o);
  scg::pq::store_rows<NX>(rows_out, B, e, r);
}

}  // namespace

// sizeof(PlanarParams), checked against the ctypes mirror at launch.
extern "C" int quad_planar_params_size() { return static_cast<int>(sizeof(PlanarParams)); }

extern "C" int quad_planar_rollout(const void* params, int nx, const void* seed, const void* rows_in,
                                   const void* action, void* rows_out, int B, int block,
                                   void* stream) {
  const PlanarParams P = *static_cast<const PlanarParams*>(params);
  const int grid = (B + block - 1) / block;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sd = static_cast<const int*>(seed);
  const float* ri = static_cast<const float*>(rows_in);
  const float* ac = static_cast<const float*>(action);
  float* ro = static_cast<float*>(rows_out);
  if (nx == 2) {
    quad_planar_rollout_kernel<2, 1><<<grid, block, 0, st>>>(P, sd, ri, ac, ro, B);
  } else if (nx == 6) {
    quad_planar_rollout_kernel<6, 2><<<grid, block, 0, st>>>(P, sd, ri, ac, ro, B);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
