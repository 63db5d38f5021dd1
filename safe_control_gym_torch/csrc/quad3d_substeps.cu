// K1: batched 3D-quadrotor actuation + physics substeps of one control step.
//
// Replaces safe_control_gym_tpu/ops/pallas_quad.py::_substeps_kernel, which
// the general engine calls once per control step (envs/quadrotor.py step).
//
// Design: one thread per env; the 12 state values, the 4 forces, the
// external force, 1/mass and the inertia stay in registers for all n_sub
// RK4 (or Euler) substeps, so device memory is read once (x, thrust, ext,
// mass, J: 23 floats) and written once (12 floats) per env.  The TPU's
// (8, B/8) sublane tiling and its B % 128 rule do not apply: any B runs and
// the tail block is masked.
//
// Bound on an H100: at B = 4096 the call moves 140 B per env (0.57 MB) and
// does about 1.9k flops and 130 transcendentals per env, under 1 us of
// bandwidth or arithmetic; a launch costs more than that, so launch latency
// sets its time.  B = 4096 threads also fill only 128 of 132 SMs with one
// warp each.  Fusing several control steps per launch is the whole-rollout
// kernel's job (quad3d_rollout.cu); CUDA graphs over the general engine's
// per-step launches are later work.
//
// The (B, 12) state rows are read as each thread's 48 contiguous bytes: a
// warp's 12 loads together cover its 1.5 KB span, so every sector fetched
// is used.
#include <cuda_runtime.h>

#include "quad3d.cuh"

namespace {

__global__ void quad3d_substeps_kernel(const float* __restrict__ x, const float* __restrict__ thrust,
                                       const float* __restrict__ ext, const float* __restrict__ mass,
                                       const float* __restrict__ jdiag, float* __restrict__ out, int B,
                                       float dt, float dt_half, float dt_sixth, int n_sub, int euler,
                                       float g, float l_sq2, float km_over_kf, int actuation) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  float s[scg::NX];
#pragma unroll
  for (int i = 0; i < scg::NX; ++i) s[i] = x[e * scg::NX + i];
  scg::Body b;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float t = thrust[e * 4 + i];
    b.f[i] = actuation ? scg::actuate(t) : t;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    b.ext[i] = ext[e * 3 + i];
    b.j[i] = jdiag[e * 3 + i];
  }
  b.minv = 1.0f / mass[e];
  b.g = g;
  b.l_sq2 = l_sq2;
  b.km_over_kf = km_over_kf;
  scg::substeps(s, b, n_sub, euler, dt, dt_half, dt_sixth);
#pragma unroll
  for (int i = 0; i < scg::NX; ++i) out[e * scg::NX + i] = s[i];
}

}  // namespace

extern "C" int quad3d_substeps(const void* x, const void* thrust, const void* ext, const void* mass,
                               const void* jdiag, void* out, int B, float dt, float dt_half,
                               float dt_sixth, int n_sub, int euler, float g, float l_sq2,
                               float km_over_kf, int actuation, int block, void* stream) {
  const int grid = (B + block - 1) / block;
  quad3d_substeps_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(thrust),
      static_cast<const float*>(ext), static_cast<const float*>(mass),
      static_cast<const float*>(jdiag), static_cast<float*>(out), B, dt, dt_half, dt_sixth,
      n_sub, euler, g, l_sq2, km_over_kf, actuation);
  return static_cast<int>(cudaGetLastError());
}
