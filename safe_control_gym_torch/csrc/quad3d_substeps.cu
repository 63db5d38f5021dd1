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
//
// Float64: the same template on double (quad3d_substeps_f64) serves the
// fidelity path, a float64 env on the card.  Its every operation is one
// IEEE double operation in the plain version's order (-fmad=false, the
// accurate double sin, cos, sqrt and division), so it agrees with the plain
// version and the NumPy oracle to ~1e-15, where float32 would not.
#include <cuda_runtime.h>

#include "quad3d.cuh"

namespace {

template <typename T>
__global__ void quad3d_substeps_kernel(const T* __restrict__ x, const T* __restrict__ thrust,
                                       const T* __restrict__ ext, const T* __restrict__ mass,
                                       const T* __restrict__ jdiag, T* __restrict__ out, int B,
                                       T dt, T dt_half, T dt_sixth, int n_sub, int euler, T g,
                                       T l_sq2, T km_over_kf, int actuation) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  T s[scg::NX];
#pragma unroll
  for (int i = 0; i < scg::NX; ++i) s[i] = x[e * scg::NX + i];
  scg::BodyT<T> b;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T t = thrust[e * 4 + i];
    b.f[i] = actuation ? scg::actuate(t) : t;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    b.ext[i] = ext[e * 3 + i];
    b.j[i] = jdiag[e * 3 + i];
  }
  b.minv = T(1) / mass[e];
  b.g = g;
  b.l_sq2 = l_sq2;
  b.km_over_kf = km_over_kf;
  scg::substeps(s, b, n_sub, euler, dt, dt_half, dt_sixth);
#pragma unroll
  for (int i = 0; i < scg::NX; ++i) out[e * scg::NX + i] = s[i];
}

template <typename T>
int launch(const void* x, const void* thrust, const void* ext, const void* mass, const void* jdiag,
           void* out, int B, T dt, T dt_half, T dt_sixth, int n_sub, int euler, T g, T l_sq2,
           T km_over_kf, int actuation, int block, void* stream) {
  const int grid = (B + block - 1) / block;
  quad3d_substeps_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(thrust), static_cast<const T*>(ext),
      static_cast<const T*>(mass), static_cast<const T*>(jdiag), static_cast<T*>(out), B, dt,
      dt_half, dt_sixth, n_sub, euler, g, l_sq2, km_over_kf, actuation);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int quad3d_substeps(const void* x, const void* thrust, const void* ext, const void* mass,
                               const void* jdiag, void* out, int B, float dt, float dt_half,
                               float dt_sixth, int n_sub, int euler, float g, float l_sq2,
                               float km_over_kf, int actuation, int block, void* stream) {
  return launch<float>(x, thrust, ext, mass, jdiag, out, B, dt, dt_half, dt_sixth, n_sub, euler, g,
                       l_sq2, km_over_kf, actuation, block, stream);
}

// The float64 instance: the same arguments, the scalars in double.
extern "C" int quad3d_substeps_f64(const void* x, const void* thrust, const void* ext,
                                   const void* mass, const void* jdiag, void* out, int B, double dt,
                                   double dt_half, double dt_sixth, int n_sub, int euler, double g,
                                   double l_sq2, double km_over_kf, int actuation, int block,
                                   void* stream) {
  return launch<double>(x, thrust, ext, mass, jdiag, out, B, dt, dt_half, dt_sixth, n_sub, euler,
                        g, l_sq2, km_over_kf, actuation, block, stream);
}
