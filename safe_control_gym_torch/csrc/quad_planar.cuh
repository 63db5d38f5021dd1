// The planar-quadrotor kernels' state (K7 quad_planar_rollout, K8
// quad_planar_policy_rollout), templated on the quad type: NX/NU = 2/1 (1D,
// z) or 6/2 (2D, x-z): parameters, rows, the action map and the actuation.
// Their control step, the JAX package's step_env_core
// (safe_control_gym_tpu/parallel/fast_quad_planar.py:161-336), is
// lane_group_planar.cuh::pq_step.  Plain version:
// safe_control_gym_torch/parallel/fast_quad_planar.py::step_rows.
//
// Every expression keeps the operand order of the plain version, and the
// library is compiled with -fmad=false, so each + and * rounds once, as the
// plain version's do.
#pragma once

#include <cstdint>

#include "cartpole.cuh"
#include "curve.cuh"
#include "quad3d.cuh"

namespace scg {
namespace pq {

// Static engine parameters, passed by value.  Mirrored field for field by
// parallel/fast_quad_planar.py::PlanarParams; arrays are sized for the 2D
// quad, the 1D quad uses their first entries.
struct PlanarParams {
  int steps, n_sub, euler;
  int cost;  // 0 rl_reward, 1 quadratic
  int task;  // 0 stabilization, 1 trajectory
  int impulse, decay_one, act_noise, u_check, done_oob, count_viol, rew_exp, normalized;
  int x_sel, z_sel;  // curve component on the x and z axes (0, 1; else none)
  int oob_mask[6];
  float dt, dt_half, dt_sixth, ctrl_dt, g, arm_l, n_motor, sqrt2;
  float a_low, a_high, norm_act_scale, hover_thrust, u_goal, rew_act_w;
  float max_steps, stab_tol, act_noise_std;
  float imp_mag, imp_peak_shift, imp_half_dur, imp_log_decay;
  float plane_off[2];
  float x_goal[6], rew_state_w[6], q_half[6], r_half[2];
  float s_low[6], s_high[6], c_low[6], c_high[6], u_low[2], u_high[2];
  float rand_a[11], rand_b[11];  // reset affine a + u * b, counter-slot order
  CurveParams curve;
};

// Row indices (fast_quad_planar.py:46-51): state | mass | iyy | step |
// offset | stats(7) | seed | ep.
template <int NX>
struct Layout {
  static constexpr int MASS = NX, IYY = NX + 1, STEP = NX + 2, OFFSET = NX + 3, STATS = NX + 4;
  static constexpr int SEED = NX + 11, EP = NX + 12, NROWS = NX + 13;
};

template <int NX>
struct Rows {
  float s[NX];
  float mass, iyy, step_f, offset, st[7], ep;
  uint32_t seed_bits;
};

template <int NX>
__device__ __forceinline__ void load_rows(const float* __restrict__ rows, int B, int e, Rows<NX>& r) {
  using L = Layout<NX>;
#pragma unroll
  for (int k = 0; k < NX; ++k) r.s[k] = rows[k * B + e];
  r.mass = rows[L::MASS * B + e];
  r.iyy = rows[L::IYY * B + e];
  r.step_f = rows[L::STEP * B + e];
  r.offset = rows[L::OFFSET * B + e];
#pragma unroll
  for (int i = 0; i < 7; ++i) r.st[i] = rows[(L::STATS + i) * B + e];
  r.seed_bits = reinterpret_cast<const uint32_t*>(rows)[L::SEED * B + e];
  r.ep = rows[L::EP * B + e];
}

template <int NX>
__device__ __forceinline__ void store_rows(float* __restrict__ rows, int B, int e, const Rows<NX>& r) {
  using L = Layout<NX>;
#pragma unroll
  for (int k = 0; k < NX; ++k) rows[k * B + e] = r.s[k];
  rows[L::MASS * B + e] = r.mass;
  rows[L::IYY * B + e] = r.iyy;
  rows[L::STEP * B + e] = r.step_f;
  rows[L::OFFSET * B + e] = r.offset;
#pragma unroll
  for (int i = 0; i < 7; ++i) rows[(L::STATS + i) * B + e] = r.st[i];
  reinterpret_cast<uint32_t*>(rows)[L::SEED * B + e] = r.seed_bits;
  rows[L::EP * B + e] = r.ep;
}

// The preprocessed thrust: the normalized action mapped around hover, else
// clipped.
__device__ __forceinline__ float preprocess(const PlanarParams& P, float a) {
  return P.normalized ? (1.0f + P.norm_act_scale * clipf(a, -1.0f, 1.0f)) * P.hover_thrust
                      : clipf(a, P.a_low, P.a_high);
}

// Thrust command -> one motor's realized force, n_motor motors sharing the
// command (fast_quad_planar.py:104-112).
__device__ __forceinline__ float actuate(float t, float n_motor) {
  float pwm = (sqrtf(maxp(t, 0.0f) / n_motor / KF) - PWM2RPM_CONST) / PWM2RPM_SCALE;
  pwm = clipf(pwm, MIN_PWM, MAX_PWM);
  const float rpm = PWM2RPM_SCALE * pwm + PWM2RPM_CONST;
  return rpm * rpm * KF;
}

template <int NX>
struct StepOut {
  float rew;
  bool done, trunc;
  float s_post[NX];  // post-step state after the freeze, before the reset
};

}  // namespace pq
}  // namespace scg
