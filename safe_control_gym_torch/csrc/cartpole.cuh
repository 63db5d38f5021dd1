// The CartPole whole-rollout kernels' control step (K5 cartpole_rollout,
// K6 cartpole_policy_rollout): the JAX package's step_env_core
// (safe_control_gym_tpu/parallel/fast_cartpole.py:100-261).  Plain version:
// safe_control_gym_torch/parallel/fast_cartpole.py::step_rows.
//
// Every expression keeps the operand order of the plain version, and the
// library is compiled with -fmad=false, so each + and * rounds once, as the
// plain version's do.
#pragma once

#include <cstdint>

#include "curve.cuh"
#include "philox.cuh"
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

// Cart-pole derivative (fast_cartpole.py:85-97).
__device__ __forceinline__ void fc(const float* s, float force, float half_l, float Mm, float ml,
                                   float pm, const CartPoleParams& P, float* d) {
  const float sin_t = sinf(s[2]), cos_t = cosf(s[2]);
  const float temp = (force + ml * (s[3] * s[3]) * sin_t) / Mm;
  const float theta_dd =
      (P.g * sin_t - cos_t * temp) / (half_l * (P.four_thirds - pm * (cos_t * cos_t) / Mm));
  const float x_dd = temp - ml * theta_dd * cos_t / Mm;
  d[0] = s[1];
  d[1] = x_dd;
  d[2] = s[3];
  d[3] = theta_dd;
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

// One control step in place on r.  force_pre: the preprocessed force (pre
// noise); act_raw: the commanded action; e, it, seed: the env, step and
// call seed that key the action white noise (Philox call site 1).
__device__ __forceinline__ void env_step(const CartPoleParams& P, Rows& r, float force_pre,
                                         float act_raw, int e, int it, uint32_t seed, StepOut& o) {
  const float act_err = force_pre - P.u_goal;
  float force = force_pre;
  if (P.act_noise) {
    const Philox4 u = philox4x32_10(e, it, 0, SITE_ACTION, seed, 0);
    const float rad = sqrtf(-2.0f * logf(1.0f - bits_to_unit(u.w[0])));
    force = force + P.act_noise_std * rad * cosf(TWO_PI * bits_to_unit(u.w[1]));
  }
  if (P.impulse)
    force = force + impulse_force(r.step_f, r.offset, P.imp_peak_shift, P.imp_half_dur,
                                  P.decay_one, P.imp_log_decay, P.imp_mag);

  const float half_l = r.pl / 2.0f;
  const float Mm = r.cm + r.pm;
  const float ml = r.pm * half_l;
  float s[NX], k1[NX], k2[NX], k3[NX], k4[NX], t[NX];
#pragma unroll
  for (int k = 0; k < NX; ++k) s[k] = r.s[k];
  for (int n = 0; n < P.n_sub; ++n) {
    fc(s, force, half_l, Mm, ml, r.pm, P, k1);
#pragma unroll
    for (int i = 0; i < NX; ++i) t[i] = s[i] + P.dt_half * k1[i];
    fc(t, force, half_l, Mm, ml, r.pm, P, k2);
#pragma unroll
    for (int i = 0; i < NX; ++i) t[i] = s[i] + P.dt_half * k2[i];
    fc(t, force, half_l, Mm, ml, r.pm, P, k3);
#pragma unroll
    for (int i = 0; i < NX; ++i) t[i] = s[i] + P.dt * k3[i];
    fc(t, force, half_l, Mm, ml, r.pm, P, k4);
#pragma unroll
    for (int i = 0; i < NX; ++i) s[i] = s[i] + P.dt_sixth * (k1[i] + 2.0f * k2[i] + 2.0f * k3[i] + k4[i]);
  }

  float goal[NX];
  if (P.task == 0) {
#pragma unroll
    for (int k = 0; k < NX; ++k) goal[k] = P.x_goal[k];
  } else {
    axis_goal(P.curve, P.plane_off, P.ctrl_dt, r.step_f, P.x_axis_sel, goal[0], goal[1]);
    goal[2] = goal[3] = 0.0f;
  }

  bool viol = false;
#pragma unroll
  for (int k = 0; k < NX; ++k) viol = viol || (s[k] < P.s_low[k]) || (s[k] > P.s_high[k]);
  if (P.u_check) viol = viol || (act_raw < P.u_low) || (act_raw > P.u_high);
  const float violf = (P.count_viol && viol) ? 1.0f : 0.0f;

  float rew;
  if (P.cost == 1) {
    float dist = P.r_half * act_err * act_err;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const float d = s[k] - goal[k];
      dist = dist + P.q_half[k] * d * d;
    }
    rew = -dist;
  } else {
    float dist = P.rew_act_w * act_err * act_err;
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
  if (P.done_oob) done = done || (fabsf(s[0]) > P.x_threshold) || (fabsf(s[2]) > P.theta_threshold);
  // Non-finite safety net: freeze the last finite state, zero the reward.
  bool finite = true;
#pragma unroll
  for (int k = 0; k < NX; ++k) finite = finite && finite_row(s[k]);
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

  // Masked auto-reset from the counter stream: slots 0..2 inertia, 3..6
  // initial state, 7 impulse offset (cartpole._reset_core).
  if (done) {
    const uint32_t base = episode_base(r.seed_bits, static_cast<uint32_t>(static_cast<int>(r.ep) + 1));
#pragma unroll
    for (int k = 0; k < NX; ++k) r.s[k] = P.rand_a[3 + k] + slot_uniform(base, 3 + k) * P.rand_b[3 + k];
    r.pl = P.rand_a[0] + slot_uniform(base, 0) * P.rand_b[0];
    r.pm = P.rand_a[1] + slot_uniform(base, 1) * P.rand_b[1];
    r.cm = P.rand_a[2] + slot_uniform(base, 2) * P.rand_b[2];
    r.offset = floorf(slot_uniform(base, 7) * P.max_steps);
    new_step = 0.0f;
    r.ep = r.ep + 1.0f;
  }
  r.step_f = new_step;
}

}  // namespace cp
}  // namespace scg
