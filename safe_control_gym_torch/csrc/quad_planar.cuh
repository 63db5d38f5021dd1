// The planar-quadrotor whole-rollout kernels' control step (K7
// quad_planar_rollout, K8 quad_planar_policy_rollout), templated on the
// quad type: NX/NU = 2/1 (1D, z) or 6/2 (2D, x-z).  The JAX package's
// step_env_core (safe_control_gym_tpu/parallel/fast_quad_planar.py:161-336).
// Plain version: safe_control_gym_torch/parallel/fast_quad_planar.py::
// step_rows.
//
// Every expression keeps the operand order of the plain version, and the
// library is compiled with -fmad=false, so each + and * rounds once, as the
// plain version's do.
#pragma once

#include <cstdint>

#include "cartpole.cuh"
#include "curve.cuh"
#include "philox.cuh"
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

// One control step in place on r.  thr: the preprocessed thrusts (pre
// noise); act: the commanded action; e, it, seed key the action white noise
// (Philox call site 1).
template <int NX, int NU>
__device__ __forceinline__ void env_step(const PlanarParams& P, Rows<NX>& r, const float* thr_pre,
                                         const float* act, int e, int it, uint32_t seed,
                                         StepOut<NX>& o) {
  float act_err[NU], thr[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    act_err[i] = thr_pre[i] - P.u_goal;
    thr[i] = thr_pre[i];
  }
  if (P.act_noise) {
    const Philox4 u = philox4x32_10(e, it, 0, SITE_ACTION, seed, 0);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const float rad = sqrtf(-2.0f * logf(1.0f - bits_to_unit(u.w[i])));
      thr[i] = thr[i] + P.act_noise_std * rad * cosf(TWO_PI * bits_to_unit(u.w[NU + i]));
    }
  }
  float fm[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) fm[i] = actuate(thr[i], P.n_motor);
  const float ext = P.impulse ? cp::impulse_force(r.step_f, r.offset, P.imp_peak_shift, P.imp_half_dur,
                                                  P.decay_one, P.imp_log_decay, P.imp_mag)
                              : 0.0f;

  const float minv = 1.0f / r.mass;
  float Tsum, theta_dd = 0.0f;
  if constexpr (NX == 2) {
    Tsum = (fm[0] + fm[0]) + fm[0] + fm[0];  // 4 motors, one command
  } else {
    const float T1 = fm[0] + fm[0], T2 = fm[1] + fm[1];  // motors (T1, T2, T2, T1)
    Tsum = T1 + T2;
    theta_dd = P.arm_l * (T2 - T1) / r.iyy / P.sqrt2;
  }
  // x' = fc(x) of quad_fc_1d / quad_fc_2d.
  auto fc = [&](const float* sv, float* d) {
    if constexpr (NX == 2) {
      d[0] = sv[1];
      d[1] = Tsum * minv - P.g + ext * minv;
    } else {
      d[0] = sv[1];
      d[1] = sinf(sv[4]) * Tsum * minv + ext * minv;
      d[2] = sv[3];
      d[3] = cosf(sv[4]) * Tsum * minv - P.g + ext * minv;
      d[4] = sv[5];
      d[5] = theta_dd;
    }
  };
  float s[NX], k1[NX], k2[NX], k3[NX], k4[NX], t[NX];
#pragma unroll
  for (int k = 0; k < NX; ++k) s[k] = r.s[k];
  for (int n = 0; n < P.n_sub; ++n) {
    fc(s, k1);
    if (P.euler) {
#pragma unroll
      for (int i = 0; i < NX; ++i) s[i] = s[i] + P.dt * k1[i];
      continue;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) t[i] = s[i] + P.dt_half * k1[i];
    fc(t, k2);
#pragma unroll
    for (int i = 0; i < NX; ++i) t[i] = s[i] + P.dt_half * k2[i];
    fc(t, k3);
#pragma unroll
    for (int i = 0; i < NX; ++i) t[i] = s[i] + P.dt * k3[i];
    fc(t, k4);
#pragma unroll
    for (int i = 0; i < NX; ++i) s[i] = s[i] + P.dt_sixth * (k1[i] + 2.0f * k2[i] + 2.0f * k3[i] + k4[i]);
  }

  // Goal rows: the static goal, or the curve on the axes the state reads.
  float goal[NX];
  if (P.task == 0) {
#pragma unroll
    for (int k = 0; k < NX; ++k) goal[k] = P.x_goal[k];
  } else if constexpr (NX == 2) {
    axis_goal(P.curve, P.plane_off, P.ctrl_dt, r.step_f, P.z_sel, goal[0], goal[1]);
  } else {
    axis_goal(P.curve, P.plane_off, P.ctrl_dt, r.step_f, P.x_sel, goal[0], goal[1]);
    axis_goal(P.curve, P.plane_off, P.ctrl_dt, r.step_f, P.z_sel, goal[2], goal[3]);
    goal[4] = goal[5] = 0.0f;
  }

  bool viol = false;
#pragma unroll
  for (int k = 0; k < NX; ++k) viol = viol || (s[k] < P.c_low[k]) || (s[k] > P.c_high[k]);
  if (P.u_check) {
#pragma unroll
    for (int i = 0; i < NU; ++i) viol = viol || (act[i] < P.u_low[i]) || (act[i] > P.u_high[i]);
  }
  const float violf = (P.count_viol && viol) ? 1.0f : 0.0f;

  float rew, dist = 0.0f;
  if (P.cost == 1) {
#pragma unroll
    for (int i = 0; i < NU; ++i) dist = dist + P.r_half[i] * act_err[i] * act_err[i];
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const float d = s[k] - goal[k];
      dist = dist + P.q_half[k] * d * d;
    }
    rew = -dist;
  } else {
#pragma unroll
    for (int i = 0; i < NU; ++i) dist = dist + P.rew_act_w * act_err[i] * act_err[i];
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const float d = s[k] - goal[k];
      dist = dist + P.rew_state_w[k] * d * d;
    }
    rew = P.rew_exp ? expf(-dist) : -dist;
  }

  bool done = false;
  if (P.cost == 1 && P.task == 0) {
    float d2 = 0.0f;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const float d = s[k] - goal[k];
      d2 = d2 + d * d;
    }
    done = sqrtf(d2) < P.stab_tol;
  }
  if (P.done_oob) {
#pragma unroll
    for (int k = 0; k < NX; ++k)
      if (P.oob_mask[k]) done = done || (s[k] < P.s_low[k]) || (s[k] > P.s_high[k]);
  }
  // Non-finite safety net: freeze the last finite state, zero the reward.
  bool finite = true;
#pragma unroll
  for (int k = 0; k < NX; ++k) finite = finite && cp::finite_row(s[k]);
  if (finite) {
#pragma unroll
    for (int k = 0; k < NX; ++k) r.s[k] = s[k];
  } else {
    rew = 0.0f;
    done = true;
  }
#pragma unroll
  for (int k = 0; k < NX; ++k) o.s_post[k] = r.s[k];

  float new_step = r.step_f + 1.0f;
  const bool timeout = new_step >= P.max_steps;
  o.trunc = timeout && !done;
  done = done || timeout;
  o.done = done;
  o.rew = rew;

  const float donef = done ? 1.0f : 0.0f;
  const float ep_ret = r.st[0] + rew;
  const float ep_len = r.st[1] + 1.0f;
  const float ep_vio = r.st[2] + violf;
  r.st[0] = ep_ret * (1.0f - donef);
  r.st[1] = ep_len * (1.0f - donef);
  r.st[2] = ep_vio * (1.0f - donef);
  r.st[3] = r.st[3] + donef;
  r.st[4] = r.st[4] + donef * ep_ret;
  r.st[5] = r.st[5] + donef * ep_len;
  r.st[6] = r.st[6] + donef * ep_vio;

  // Masked auto-reset from the counter stream: slots 0..3 inertia (M, Ixx,
  // Iyy, Izz), 4..4+NX-1 initial state, 4+NX impulse offset.
  if (done) {
    const uint32_t base = episode_base(r.seed_bits, static_cast<uint32_t>(static_cast<int>(r.ep) + 1));
#pragma unroll
    for (int k = 0; k < NX; ++k) r.s[k] = P.rand_a[4 + k] + slot_uniform(base, 4 + k) * P.rand_b[4 + k];
    r.mass = P.rand_a[0] + slot_uniform(base, 0) * P.rand_b[0];
    r.iyy = P.rand_a[2] + slot_uniform(base, 2) * P.rand_b[2];
    r.offset = floorf(slot_uniform(base, 4 + NX) * P.max_steps);
    new_step = 0.0f;
    r.ep = r.ep + 1.0f;
  }
  r.step_f = new_step;
}

}  // namespace pq
}  // namespace scg
