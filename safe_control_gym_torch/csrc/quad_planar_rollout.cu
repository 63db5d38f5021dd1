// K7: whole constant-action rollout of the 1D or 2D quadrotor, many control
// steps per launch.
//
// Replaces safe_control_gym_tpu/parallel/fast_quad_planar.py::_rollout_kernel
// (:339): per control step, the grouped step scg::grp::pq_step (action
// white noise, motor-grouped actuation, impulse, RK4 or Euler substeps of
// quad_fc_1d / quad_fc_2d, closed-form goal, reward, out-of-bound done and
// the non-finite freeze, box violations, statistics and the counter-PRNG
// auto-reset over slots 0..4+nx), also K8's.  Plain version:
// safe_control_gym_torch/parallel/fast_quad_planar.py::planar_rollout_plain.
//
// Layout: state rows (nx + 13, B) = (15, B) or (19, B), row r of env b at
// r*B + b; action (nu, B).  One template on NX/NU serves both quad types.
//
// Design: one env over a group of G lanes of a warp
// (csrc/lane_group_planar.cuh::pq_step), its rows in every lane's registers
// for the whole call, a loop over `steps` in place of the TPU's fori_loop;
// device memory is touched once in and once out per call.
//
// Bound on an H100: operations.  A 2D env-step at 4 RK4 substeps is ~610
// operations counting each transcendental as one (chip_smoke.py::bounds:
// 16 derivatives of a sine, a cosine and 9 operations, 2 actuations,
// reward, statistics); at B = 4096 and 4096 steps that is ~1.03e10
// operations (0.153 ms at 67 TFLOP/s) against 0.66 MB moved.  With one
// thread per env a 2D step was one dependent chain of ~43 convergence
// regions (each accurate sin/cos, sqrt and IEEE division) in 128 warps.
// The group takes the 16 stage angles' sincosf off the chain (they depend
// on theta and theta_dot alone), computes the actuation, 1/mass and
// theta_dd once a call and after a reset when the command is constant, and
// makes G times as many warps; the launch plan
// (fast_quad_planar.py::launch_plan) takes 4, 2 or 1 lanes by B, as
// measured fastest (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "lane_group_planar.cuh"
#include "quad_planar.cuh"

namespace {

using scg::pq::PlanarParams;

constexpr int BLOCK = 128;  // the largest block the launch plan asks for

// At least one block an SM (the bound the kernels were measured with; a
// block-size-only bound spilled in K2, PERF.md).
template <int NX, int NU, int G>
__global__ void __launch_bounds__(BLOCK, 1) quad_planar_rollout_kernel(
    const PlanarParams P, const int* __restrict__ seed_ptr, const float* __restrict__ rows_in,
    const float* __restrict__ action, float* __restrict__ rows_out, int B) {
  const scg::LaneGroup g = scg::lane_group<G>(B);
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  scg::pq::Rows<NX> r;
  scg::pq::load_rows<NX>(rows_in, B, g.e, r);
  // The action is constant over the call, and so is its preprocessing; so
  // are the motor forces without action noise.
  float act[NU], thr[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    act[i] = action[i * B + g.e];
    thr[i] = scg::pq::preprocess(P, act[i]);
  }
  scg::grp::ForceSlots<NU, G> fs;
  if (!P.act_noise) scg::grp::constant_forces<NU, G>(P, thr, fs, g);
  scg::grp::PlanarBody b{};
  bool fresh = true;
  scg::pq::StepOut<NX> unused;  // K7 records nothing
  for (int it = 0; it < P.steps; ++it)
    fresh = scg::grp::pq_step<NX, NU, G>(P, r, thr, act, it, seed, fs, fresh, b, g, unused);
  if (g.valid && g.gl == 0) scg::pq::store_rows<NX>(rows_out, B, g.e, r);
}

template <int NX, int NU, int G>
int launch(const PlanarParams& P, const int* seed, const float* rows_in, const float* action,
           float* rows_out, int B, int block, int grid, cudaStream_t st) {
  quad_planar_rollout_kernel<NX, NU, G><<<grid, block, 0, st>>>(P, seed, rows_in, action, rows_out, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sizeof(PlanarParams), checked against the ctypes mirror at launch.
extern "C" int quad_planar_params_size() { return static_cast<int>(sizeof(PlanarParams)); }

// 2: the entry takes the launch plan (fast_quad_planar.py::launch_plan).
extern "C" int quad_planar_rollout_api_version() { return 2; }

extern "C" int quad_planar_rollout(const void* params, int nx, const void* seed, const void* rows_in,
                                   const void* action, void* rows_out, int B, int group, int block,
                                   int grid, void* stream) {
  if (group < 1 || block < 32 || block > BLOCK || block % 32 != 0 ||
      static_cast<long long>(grid) * (block / group) < B)
    return static_cast<int>(cudaErrorInvalidValue);
  const PlanarParams P = *static_cast<const PlanarParams*>(params);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sd = static_cast<const int*>(seed);
  const float* ri = static_cast<const float*>(rows_in);
  const float* ac = static_cast<const float*>(action);
  float* ro = static_cast<float*>(rows_out);
  // The group sizes fast_quad_planar.py::launch_plan picks from.
  if (nx == 2 && group == 1) return launch<2, 1, 1>(P, sd, ri, ac, ro, B, block, grid, st);
  if (nx == 2 && group == 2) return launch<2, 1, 2>(P, sd, ri, ac, ro, B, block, grid, st);
  if (nx == 2 && group == 4) return launch<2, 1, 4>(P, sd, ri, ac, ro, B, block, grid, st);
  if (nx == 6 && group == 1) return launch<6, 2, 1>(P, sd, ri, ac, ro, B, block, grid, st);
  if (nx == 6 && group == 2) return launch<6, 2, 2>(P, sd, ri, ac, ro, B, block, grid, st);
  if (nx == 6 && group == 4) return launch<6, 2, 4>(P, sd, ri, ac, ro, B, block, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
