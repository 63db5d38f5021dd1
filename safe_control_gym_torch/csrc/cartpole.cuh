// The CartPole kernels' state (K5 cartpole_rollout, K6
// cartpole_policy_rollout): parameters, rows, the action map and the
// impulse.  Their control step, the JAX package's step_env_core
// (safe_control_gym_tpu/parallel/fast_cartpole.py:100-261), is
// lane_group_planar.cuh::cp_step.  Plain version:
// safe_control_gym_torch/parallel/fast_cartpole.py::step_rows.
//
// Every expression keeps the operand order of the plain version, and the
// library is compiled with -fmad=false, so each + and * rounds once, as the
// plain version's do.
#pragma once

#include <cstdint>

#include "curve.cuh"
#include "quad3d.cuh"

namespace scg {
namespace cp {

// Row indices (fast_cartpole.py:46-53).
constexpr int NX = 4;
constexpr int R_PL = 4, R_PM = 5, R_CM = 6, R_STEP = 7, R_OFFSET = 8, R_STATS = 9;
constexpr int R_SEED = 16, R_EP = 17, NROWS = 18;

// Static engine parameters, passed by value.  Mirrored field for field by
// parallel/fast_cartpole.py::CartPoleParams.
struct CartPoleParams {
  int steps, n_sub;
  int cost;  // 0 rl_reward, 1 quadratic
  int task;  // 0 stabilization, 1 trajectory
  int impulse, decay_one, act_noise, u_check, done_oob, count_viol, rew_exp, normalized;
  int x_axis_sel;  // curve component on the x axis (0, 1; else none)
  float dt, dt_half, dt_sixth, ctrl_dt, g, four_thirds, a_low, a_high;
  float act_scale, u_goal, rew_act_w, r_half, max_steps, stab_tol;
  float x_threshold, theta_threshold, u_low, u_high, act_noise_std;
  float imp_mag, imp_peak_shift, imp_half_dur, imp_log_decay;
  float plane_off[2];
  float x_goal[4], rew_state_w[4], q_half[4], s_low[4], s_high[4];
  float rand_a[7], rand_b[7];  // reset affine a + u * b, counter-slot order
  CurveParams curve;
};

// One env's 18 rows, held in registers for a whole call; the seed row is a
// bit pattern, never used in float arithmetic.
struct Rows {
  float s[NX];
  float pl, pm, cm, step_f, offset, st[7], ep;
  uint32_t seed_bits;
};

__device__ __forceinline__ void load_rows(const float* __restrict__ rows, int B, int e, Rows& r) {
#pragma unroll
  for (int k = 0; k < NX; ++k) r.s[k] = rows[k * B + e];
  r.pl = rows[R_PL * B + e];
  r.pm = rows[R_PM * B + e];
  r.cm = rows[R_CM * B + e];
  r.step_f = rows[R_STEP * B + e];
  r.offset = rows[R_OFFSET * B + e];
#pragma unroll
  for (int i = 0; i < 7; ++i) r.st[i] = rows[(R_STATS + i) * B + e];
  r.seed_bits = reinterpret_cast<const uint32_t*>(rows)[R_SEED * B + e];
  r.ep = rows[R_EP * B + e];
}

__device__ __forceinline__ void store_rows(float* __restrict__ rows, int B, int e, const Rows& r) {
#pragma unroll
  for (int k = 0; k < NX; ++k) rows[k * B + e] = r.s[k];
  rows[R_PL * B + e] = r.pl;
  rows[R_PM * B + e] = r.pm;
  rows[R_CM * B + e] = r.cm;
  rows[R_STEP * B + e] = r.step_f;
  rows[R_OFFSET * B + e] = r.offset;
#pragma unroll
  for (int i = 0; i < 7; ++i) rows[(R_STATS + i) * B + e] = r.st[i];
  reinterpret_cast<uint32_t*>(rows)[R_SEED * B + e] = r.seed_bits;
  rows[R_EP * B + e] = r.ep;
}

// The preprocessed force: the normalized action scaled, else clipped.
__device__ __forceinline__ float preprocess(const CartPoleParams& P, float a) {
  return P.normalized ? P.act_scale * clipf(a, -1.0f, 1.0f) : clipf(a, P.a_low, P.a_high);
}

// The kernels' finite test (fast_cartpole.py:212-218): values above 3e38
// count as non-finite.
__device__ __forceinline__ bool finite_row(float v) { return v == v && fabsf(v) < 3.0e38f; }

// What a step reports besides the new rows.
struct StepOut {
  float rew;
  bool done, trunc;
  float s_post[NX];  // post-step state after the freeze, before the reset
};

// The impulse force at a step (fast_env.py:356-366).
__device__ __forceinline__ float impulse_force(float step_f, float offset, float peak_shift,
                                               float half_dur, int decay_one, float log_decay,
                                               float mag) {
  const float po = fabsf(step_f - (offset + peak_shift));
  const float dec = po < half_dur ? (decay_one ? 1.0f : expf(po * log_decay)) : 0.0f;
  return step_f >= offset ? mag * dec : 0.0f;
}

}  // namespace cp
}  // namespace scg
