// K1: batched 3D-quadrotor actuation + physics substeps of one control step.
//
// Replaces safe_control_gym_tpu/ops/pallas_quad.py::_substeps_kernel, which
// the general engine calls once per control step (envs/quadrotor.py step).
//
// Design: one env over a group of G lanes of a warp (csrc/lane_group.cuh).
// Every lane loads its env's 12 state values, 4 thrusts, the external
// force, the mass and the inertia, and keeps them in registers for all
// n_sub RK4 (or Euler) substeps, so device memory is read once (23 values)
// and written once (12 values) per env.  Lane i < 4 actuates motor i (with
// more than four lanes, lane 4 divides 1 by the mass beside the motors'
// first division), and the forces go round by scg::from; then the group
// runs the substeps (scg::substeps_group: one sincos round and
// ceil(6 / G) division rounds per derivative).  The TPU's (8, B/8) sublane
// tiling and its B % 128 rule do not apply: any B runs, and the lanes of
// the last block's groups past env B - 1 run env B - 1 and store nothing.
//
// What bounds it on an H100: neither bytes nor operations.  At B = 4096 a
// call moves 0.57 MB and does ~2k flops per env, 0.17 us of the card's
// bandwidth; with one thread per env the launch took 13.2 us, one chain of
// ~205 convergence regions per thread (each accurate sin/cos, sqrt and IEEE
// division sits in one), at 64 envs a block on 64 of the 132 SMs.  The
// group runs a derivative's regions side by side and gives G times as many
// warps; its launch plan (ops/quad_substeps.py::launch_plan) picks G by B
// and the scalar type from the sweep in PERF.md.
//
// Float64: the same template on double (quad3d_substeps_f64) serves the
// fidelity path, a float64 env on the card.  Its every operation is one
// IEEE double operation in the plain version's order (-fmad=false, the
// accurate double sincos, sqrt and division), so it agrees with the plain
// version and the NumPy oracle to ~1e-15, where float32 would not.
#include <cuda_runtime.h>

#include "lane_group.cuh"
#include "quad3d.cuh"

namespace {

constexpr int BLOCK = 256;  // the largest block an entry takes

// The four motor forces and 1/mass over the group: lane i takes motor i's
// actuation in rounds of G lanes (scg::actuate: the same operations), and in
// a group of more than four lanes lane 4 takes 1/mass as its first
// division.
template <int G, typename T>
__device__ __forceinline__ void actuation_group(const T (&cmd)[4], T mass, int actuation,
                                                const scg::LaneGroup& g, scg::BodyT<T>& b) {
  constexpr bool SPARE = G > 4;
  if (!actuation) {
#pragma unroll
    for (int i = 0; i < 4; ++i) b.f[i] = cmd[i];
    b.minv = T(1) / mass;
    return;
  }
  T ratio = T(0);
#pragma unroll
  for (int r0 = 0; r0 < 4; r0 += G) {
    T t = cmd[r0];
#pragma unroll
    for (int i = 1; i < G && r0 + i < 4; ++i) t = g.gl >= i ? cmd[r0 + i] : t;
    T n = scg::maxp(t, T(0)), d = scg::Motor<T>::kf;
    if constexpr (SPARE) {
      n = g.gl == 4 ? T(1) : n;
      d = g.gl == 4 ? mass : d;
    }
    ratio = n / d;
    const T f = scg::actuate_ratio(ratio);
#pragma unroll
    for (int i = 0; i < G && r0 + i < 4; ++i) b.f[r0 + i] = scg::from<G>(f, g, i);
  }
  if constexpr (SPARE) {
    b.minv = scg::from<G>(ratio, g, 4);
  } else {
    b.minv = T(1) / mass;
  }
}

// T: the scalar type; G: lanes per env.
template <typename T, int G>
__global__ void __launch_bounds__(BLOCK) quad3d_substeps_kernel(
    const T* __restrict__ x, const T* __restrict__ thrust, const T* __restrict__ ext,
    const T* __restrict__ mass, const T* __restrict__ jdiag, T* __restrict__ out, int B, T dt,
    T dt_half, T dt_sixth, int n_sub, int euler, T g, T l_sq2, T km_over_kf, int actuation) {
  const scg::LaneGroup lg = scg::lane_group<G>(B);
  const int e = lg.e;
  T s[scg::NX], cmd[4];
#pragma unroll
  for (int i = 0; i < scg::NX; ++i) s[i] = x[e * scg::NX + i];
#pragma unroll
  for (int i = 0; i < 4; ++i) cmd[i] = thrust[e * 4 + i];
  scg::BodyT<T> b;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    b.ext[i] = ext[e * 3 + i];
    b.j[i] = jdiag[e * 3 + i];
  }
  actuation_group<G>(cmd, mass[e], actuation, lg, b);
  b.g = g;
  b.l_sq2 = l_sq2;
  b.km_over_kf = km_over_kf;
  scg::substeps_group<G>(s, b, n_sub, euler, dt, dt_half, dt_sixth, lg);
  // Lane gl stores values gl, gl + G, ... (1.0-1.3% faster than lane 0
  // storing all twelve at 4 and 8 lanes, PERF.md).
#pragma unroll
  for (int i0 = 0; i0 < scg::NX; i0 += G) {
    T v = s[i0];
#pragma unroll
    for (int i = 1; i < G && i0 + i < scg::NX; ++i) v = lg.gl >= i ? s[i0 + i] : v;
    if (lg.valid && i0 + lg.gl < scg::NX) out[e * scg::NX + i0 + lg.gl] = v;
  }
}

template <typename T, int G>
int launch(const void* x, const void* thrust, const void* ext, const void* mass, const void* jdiag,
           void* out, int B, T dt, T dt_half, T dt_sixth, int n_sub, int euler, T g, T l_sq2,
           T km_over_kf, int actuation, int block, int grid, void* stream) {
  quad3d_substeps_kernel<T, G><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(thrust), static_cast<const T*>(ext),
      static_cast<const T*>(mass), static_cast<const T*>(jdiag), static_cast<T*>(out), B, dt,
      dt_half, dt_sixth, n_sub, euler, g, l_sq2, km_over_kf, actuation);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan (ops/quad_substeps.py::launch_plan): the group sizes
// built, whole warps of whole groups, enough blocks for B envs.
template <typename T>
int dispatch(const void* x, const void* thrust, const void* ext, const void* mass,
             const void* jdiag, void* out, int B, T dt, T dt_half, T dt_sixth, int n_sub, int euler,
             T g, T l_sq2, T km_over_kf, int actuation, int group, int block, int grid,
             void* stream) {
  if (group < 1 || block < 32 || block > BLOCK || block % 32 != 0 ||
      static_cast<long long>(grid) * (block / group) < B)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (group) {
    case 1:
      return launch<T, 1>(x, thrust, ext, mass, jdiag, out, B, dt, dt_half, dt_sixth, n_sub, euler,
                          g, l_sq2, km_over_kf, actuation, block, grid, stream);
    case 2:
      return launch<T, 2>(x, thrust, ext, mass, jdiag, out, B, dt, dt_half, dt_sixth, n_sub, euler,
                          g, l_sq2, km_over_kf, actuation, block, grid, stream);
    case 4:
      return launch<T, 4>(x, thrust, ext, mass, jdiag, out, B, dt, dt_half, dt_sixth, n_sub, euler,
                          g, l_sq2, km_over_kf, actuation, block, grid, stream);
    case 8:
      return launch<T, 8>(x, thrust, ext, mass, jdiag, out, B, dt, dt_half, dt_sixth, n_sub, euler,
                          g, l_sq2, km_over_kf, actuation, block, grid, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// 2: the entries take the launch plan (group, block, grid).
extern "C" int quad3d_substeps_api_version() { return 2; }

extern "C" int quad3d_substeps(const void* x, const void* thrust, const void* ext, const void* mass,
                               const void* jdiag, void* out, int B, float dt, float dt_half,
                               float dt_sixth, int n_sub, int euler, float g, float l_sq2,
                               float km_over_kf, int actuation, int group, int block, int grid,
                               void* stream) {
  return dispatch<float>(x, thrust, ext, mass, jdiag, out, B, dt, dt_half, dt_sixth, n_sub, euler,
                         g, l_sq2, km_over_kf, actuation, group, block, grid, stream);
}

// The float64 instance: the same arguments, the scalars in double.
extern "C" int quad3d_substeps_f64(const void* x, const void* thrust, const void* ext,
                                   const void* mass, const void* jdiag, void* out, int B, double dt,
                                   double dt_half, double dt_sixth, int n_sub, int euler, double g,
                                   double l_sq2, double km_over_kf, int actuation, int group,
                                   int block, int grid, void* stream) {
  return dispatch<double>(x, thrust, ext, mass, jdiag, out, B, dt, dt_half, dt_sixth, n_sub, euler,
                          g, l_sq2, km_over_kf, actuation, group, block, grid, stream);
}
