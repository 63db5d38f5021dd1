// One env over a group of G lanes of a warp: the grouped control steps of
// the CartPole and planar-quadrotor kernels, the whole-rollout kernels (K5
// cartpole_rollout, K7 quad_planar_rollout) and the policy kernels (K6
// cartpole_policy_rollout, K8 quad_planar_policy_rollout).  These are the
// only implementations of those steps.
//
// Why: with one thread per env, B = 4096 envs are 128 warps for the card's
// 528 warp schedulers, and each thread's step is one dependent chain in
// which each accurate sinf/cosf, sqrtf and IEEE division is a region of its
// own (a convergence barrier around its rare slow path), run one after
// another.  A group shortens that chain:
//
// - CartPole (cp_step): the angle theta and its rate feed no cart row, so
//   the chain of an RK4 substep is the theta chain: per stage a division
//   for `temp` and one for theta_dd.  The group runs the divisions that are
//   ready together (the other stages' pm cos^2 / Mm, the cart's x_dd, which
//   feeds no angle) and the sines and cosines of two stage angles in one
//   sincosf round: 11 regions a substep in place of 24.  The goal's curve
//   angle joins the first round, and the action noise of G steps is drawn
//   in one round every G steps (it depends on env, step and seed only).
// - Planar quad (pq_step): theta_dd is constant over a step, so the angle
//   pair (theta, theta_dot) evolves by adds and multiplies alone.  The
//   group computes the angles of G RK4 stages (or Euler substeps) ahead and
//   their sincosf side by side, one a lane; the x-z chain that is left has
//   no region.  Under a constant command (K7) actuation, 1/mass and
//   theta_dd run once a call and after a reset, and the noisy actuation of
//   G / NU steps is drawn in one round.  Under a policy (K6, K8: POLICY)
//   the command changes every step: the noise terms of G / NU steps are
//   drawn in one round, and every step actuates its own thrusts (one input
//   a lane) and makes its body.
//
// The group pays where one thread per env leaves the card's issue slots
// idle (B = 4096: 128 warps for 528 schedulers) and loses where the lanes'
// repeated work fills them, so the kernels are built for several group
// sizes and the host's launch plan picks one by B (PERF.md).  A group of
// fewer lanes than a round's values takes the round in turns; a group of
// more lanes repeats the round's last value on the lanes past it.
//
// What does not change: every value is computed by the same float32
// operations in the same order as the one-thread steps that K5-K8 ran
// before (and as the plain versions, fast_cartpole.py::step_rows and
// fast_quad_planar.py::step_rows), only on another lane, so the rows are
// bit-equal to theirs.  Lanes exchange finished values (__shfl_sync), never
// partial sums, and every lane of a group holds the env's rows and runs the
// rest of the step on identical registers.  No lane returns early: a lane
// past the last env runs env B - 1 (LaneGroup::e) and stores nothing, so
// every lane of a warp joins every exchange (full-warp masks), and a
// per-env branch that exchanges values is taken by the whole warp.
#pragma once

#include <cstdint>

#include "cartpole.cuh"
#include "curve.cuh"
#include "lane_group.cuh"
#include "philox.cuh"
#include "quad_planar.cuh"

namespace scg {
namespace grp {

__device__ __forceinline__ uint32_t word(const Philox4& u, int k) {
  return k == 0 ? u.w[0] : k == 1 ? u.w[1] : k == 2 ? u.w[2] : u.w[3];
}

// The action white noise of input i at step it of env e, std * rad * cos
// (Box-Muller on Philox call site 1; NU inputs a block), the term the plain
// versions add (fast_cartpole.py / fast_quad_planar.py::step_rows).
template <int NU>
__device__ __forceinline__ float noise_term(int e, int it, int i, uint32_t seed, float std) {
  const Philox4 u = philox4x32_10(e, it, 0, SITE_ACTION, seed, 0);
  const float rad = sqrtf(-2.0f * logf(1.0f - bits_to_unit(word(u, i))));
  float s, c;
  sincosf(TWO_PI * bits_to_unit(word(u, NU + i)), &s, &c);
  return std * rad * c;
}

// Position and velocity on the world axis that curve component `sel` (0 or
// 1) lands on, offset by the plane offset of that component, zeros for any
// other sel (fast_cartpole.py:167-174, fast_quad_planar.py:128-133), with
// the sine and cosine of the curve angle given (the figure-8 and circle use
// them; the square has none).
__device__ __forceinline__ void axis_goal_sc(const CurveParams& C, const float* plane_off,
                                             float ctrl_dt, float step_f, int sel, float sw,
                                             float cw, float& pos, float& vel) {
  if (sel != 0 && sel != 1) {
    pos = 0.0f;
    vel = 0.0f;
    return;
  }
  float a_p, b_p, a_v, b_v;
  if (C.traj_type == 0) {
    a_p = C.traj_scale * sw;
    b_p = C.traj_scale * sw * cw;
    a_v = C.traj_sc_w * cw;
    b_v = C.traj_sc_w * (cw * cw - sw * sw);
  } else if (C.traj_type == 1) {
    a_p = C.traj_scale * cw;
    b_p = C.traj_scale * sw;
    a_v = C.traj_neg_sc_w * sw;
    b_v = C.traj_sc_w * cw;
  } else {
    square_curve(C, step_f * ctrl_dt, a_p, b_p, a_v, b_v);
  }
  pos = sel == 0 ? a_p + plane_off[0] : b_p + plane_off[1];
  vel = sel == 0 ? a_v : b_v;
}

// The curve angle traj_w * t of a step (fast_env.py::eval_curve's first
// product).
__device__ __forceinline__ float curve_angle(const CurveParams& C, float ctrl_dt, float step_f) {
  return C.traj_w * (step_f * ctrl_dt);
}

// The statistics rows and the time limit of a step (after the freeze);
// returns the final done flag.
__device__ __forceinline__ bool step_stats(float* st, float step_f, float max_steps, float rew,
                                           float violf, bool done, float& new_step) {
  new_step = step_f + 1.0f;
  const bool timeout = new_step >= max_steps;
  done = done || timeout;
  const float donef = done ? 1.0f : 0.0f;
  const float ep_ret = st[0] + rew;
  const float ep_len = st[1] + 1.0f;
  const float ep_vio = st[2] + violf;
  st[0] = ep_ret * (1.0f - donef);
  st[1] = ep_len * (1.0f - donef);
  st[2] = ep_vio * (1.0f - donef);
  st[3] = st[3] + donef;
  st[4] = st[4] + donef * ep_ret;
  st[5] = st[5] + donef * ep_len;
  st[6] = st[6] + donef * ep_vio;
  return done;
}

// ---------------------------------------------------------------------------
// CartPole (K5).
// ---------------------------------------------------------------------------

// One RK4 substep of cartpole.cuh::fc on s in place over the group (a
// round takes up to four lanes; a smaller group takes it in turns).  sw,
// cw: the sine and cosine of `goal_ang`, a third angle taken in the first
// sincosf round.
template <int G>
__device__ __forceinline__ void cp_substep(const cp::CartPoleParams& P, float* s, float force,
                                           float half_l, float Mm, float ml, float pm, float goal_ang,
                                           float& sw, float& cw, const LaneGroup& g) {
  const float g_ = P.g, ft = P.four_thirds;
  // Round 1: stage 1's and 2's angles (known now), and the goal's.
  const float a[3] = {s[2], s[2] + P.dt_half * s[3], goal_ang};
  float sn[3], cs[3];
  sincos_round<G, 3>(a, sn, cs, g);
  sw = sn[2];
  cw = cs[2];
  // Round 2: stage 1's temp and the pm cos^2 / Mm of stages 1 and 2.
  float q2[3];
  {
    const float num[3] = {force + ml * (s[3] * s[3]) * sn[0], pm * (cs[0] * cs[0]),
                          pm * (cs[1] * cs[1])};
    const float den[3] = {Mm, Mm, Mm};
    div_round<G, 3>(num, den, q2, g);
  }
  const float temp1 = q2[0], c2_1 = q2[1], c2_2 = q2[2];
  // Round 3: stage 1's theta_dd.
  float q3[1];
  {
    const float num[1] = {g_ * sn[0] - cs[0] * temp1};
    const float den[1] = {half_l * (ft - c2_1)};
    div_round<G, 1>(num, den, q3, g);
  }
  const float thdd1 = q3[0];
  const float t3 = s[3] + P.dt_half * thdd1;
  // Round 4: stage 2's temp, stage 1's x_dd term.
  float q4[2];
  {
    const float num[2] = {force + ml * (t3 * t3) * sn[1], ml * thdd1 * cs[0]};
    const float den[2] = {Mm, Mm};
    div_round<G, 2>(num, den, q4, g);
  }
  const float temp2 = q4[0], xdd1 = temp1 - q4[1];
  // Round 5: stage 2's theta_dd.
  float q5[1];
  {
    const float num[1] = {g_ * sn[1] - cs[1] * temp2};
    const float den[1] = {half_l * (ft - c2_2)};
    div_round<G, 1>(num, den, q5, g);
  }
  const float thdd2 = q5[0];
  const float u3 = s[3] + P.dt_half * thdd2;
  // Round 6: stage 3's and 4's angles.
  float sn2[2], cs2[2];
  {
    const float a2[2] = {s[2] + P.dt_half * t3, s[2] + P.dt * u3};
    sincos_round<G, 2>(a2, sn2, cs2, g);
  }
  // Round 7: stage 3's temp, pm cos^2 / Mm of stages 3 and 4, stage 2's x_dd term.
  float q7[4];
  {
    const float num[4] = {force + ml * (u3 * u3) * sn2[0], pm * (cs2[0] * cs2[0]),
                          pm * (cs2[1] * cs2[1]), ml * thdd2 * cs[1]};
    const float den[4] = {Mm, Mm, Mm, Mm};
    div_round<G, 4>(num, den, q7, g);
  }
  const float temp3 = q7[0], c2_3 = q7[1], c2_4 = q7[2], xdd2 = temp2 - q7[3];
  // Round 8: stage 3's theta_dd.
  float q8[1];
  {
    const float num[1] = {g_ * sn2[0] - cs2[0] * temp3};
    const float den[1] = {half_l * (ft - c2_3)};
    div_round<G, 1>(num, den, q8, g);
  }
  const float thdd3 = q8[0];
  const float v3 = s[3] + P.dt * thdd3;
  // Round 9: stage 4's temp, stage 3's x_dd term.
  float q9[2];
  {
    const float num[2] = {force + ml * (v3 * v3) * sn2[1], ml * thdd3 * cs2[0]};
    const float den[2] = {Mm, Mm};
    div_round<G, 2>(num, den, q9, g);
  }
  const float temp4 = q9[0], xdd3 = temp3 - q9[1];
  // Round 10: stage 4's theta_dd.
  float q10[1];
  {
    const float num[1] = {g_ * sn2[1] - cs2[1] * temp4};
    const float den[1] = {half_l * (ft - c2_4)};
    div_round<G, 1>(num, den, q10, g);
  }
  const float thdd4 = q10[0];
  // Round 11: stage 4's x_dd term.
  float q11[1];
  {
    const float num[1] = {ml * thdd4 * cs2[1]};
    const float den[1] = {Mm};
    div_round<G, 1>(num, den, q11, g);
  }
  const float xdd4 = temp4 - q11[0];

  // The stage derivatives k1..k4 of the substep, then its combine.
  const float t1 = s[1] + P.dt_half * xdd1;
  const float u1 = s[1] + P.dt_half * xdd2;
  const float v1 = s[1] + P.dt * xdd3;
  const float k1[4] = {s[1], xdd1, s[3], thdd1};
  const float k2[4] = {t1, xdd2, t3, thdd2};
  const float k3[4] = {u1, xdd3, u3, thdd3};
  const float k4[4] = {v1, xdd4, v3, thdd4};
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = s[i] + P.dt_sixth * (k1[i] + 2.0f * k2[i] + 2.0f * k3[i] + k4[i]);
}

// One CartPole control step in place on r over the group (the JAX
// package's step_env_core, fast_cartpole.py:100-261): action white noise,
// impulse, RK4, goal, violation, reward, done and the non-finite freeze,
// statistics, counter-PRNG auto-reset.  force_pre: the preprocessed force
// (pre noise); act_raw: the commanded action; nz: this lane's action-noise
// term of the current chunk of G steps (lane i holds step it - it % G +
// i's), redrawn here when it % G == 0.  With REC (the policy kernel) o
// receives the step's reward, done and truncation flags and the state after
// the freeze, before the reset; without, o is not written.
template <int G, bool REC = false>
__device__ __forceinline__ void cp_step(const cp::CartPoleParams& P, cp::Rows& r, float force_pre,
                                        float act_raw, int it, uint32_t seed, float& nz,
                                        const LaneGroup& g, cp::StepOut& o) {
  const float act_err = force_pre - P.u_goal;
  float force = force_pre;
  if (P.act_noise) {
    if (it % G == 0) nz = noise_term<1>(g.e, it + g.gl, 0, seed, P.act_noise_std);
    force = force + from<G>(nz, g, it % G);
  }
  if (P.impulse)
    force = force + cp::impulse_force(r.step_f, r.offset, P.imp_peak_shift, P.imp_half_dur,
                                      P.decay_one, P.imp_log_decay, P.imp_mag);

  const float half_l = r.pl / 2.0f;
  const float Mm = r.cm + r.pm;
  const float ml = r.pm * half_l;
  const float goal_ang = curve_angle(P.curve, P.ctrl_dt, r.step_f);
  float s[cp::NX];
#pragma unroll
  for (int k = 0; k < cp::NX; ++k) s[k] = r.s[k];
  float sw = 0.0f, cw = 0.0f, sw_n, cw_n;
  for (int n = 0; n < P.n_sub; ++n) {
    cp_substep<G>(P, s, force, half_l, Mm, ml, r.pm, goal_ang, sw_n, cw_n, g);
    if (n == 0) {
      sw = sw_n;
      cw = cw_n;
    }
  }

  float goal[cp::NX];
  if (P.task == 0) {
#pragma unroll
    for (int k = 0; k < cp::NX; ++k) goal[k] = P.x_goal[k];
  } else {
    axis_goal_sc(P.curve, P.plane_off, P.ctrl_dt, r.step_f, P.x_axis_sel, sw, cw, goal[0], goal[1]);
    goal[2] = goal[3] = 0.0f;
  }

  bool viol = false;
#pragma unroll
  for (int k = 0; k < cp::NX; ++k) viol = viol || (s[k] < P.s_low[k]) || (s[k] > P.s_high[k]);
  if (P.u_check) viol = viol || (act_raw < P.u_low) || (act_raw > P.u_high);
  const float violf = (P.count_viol && viol) ? 1.0f : 0.0f;

  float rew;
  if (P.cost == 1) {
    float dist = P.r_half * act_err * act_err;
#pragma unroll
    for (int k = 0; k < cp::NX; ++k) {
      const float d = s[k] - goal[k];
      dist = dist + P.q_half[k] * d * d;
    }
    rew = -dist;
  } else {
    float dist = P.rew_act_w * act_err * act_err;
#pragma unroll
    for (int k = 0; k < cp::NX; ++k) {
      const float d = s[k] - goal[k];
      dist = dist + P.rew_state_w[k] * d * d;
    }
    rew = P.rew_exp ? expf(-dist) : -dist;
  }

  bool done = false;
  if (P.cost == 1 && P.task == 0) {
    float d2 = 0.0f;
#pragma unroll
    for (int k = 0; k < cp::NX; ++k) {
      const float d = s[k] - goal[k];
      d2 = d2 + d * d;
    }
    done = sqrtf(d2) < P.stab_tol;
  }
  if (P.done_oob) done = done || (fabsf(s[0]) > P.x_threshold) || (fabsf(s[2]) > P.theta_threshold);
  bool finite = true;
#pragma unroll
  for (int k = 0; k < cp::NX; ++k) finite = finite && cp::finite_row(s[k]);
  if (finite) {
#pragma unroll
    for (int k = 0; k < cp::NX; ++k) r.s[k] = s[k];
  } else {
    rew = 0.0f;
    done = true;
  }
  if constexpr (REC) {
#pragma unroll
    for (int k = 0; k < cp::NX; ++k) o.s_post[k] = r.s[k];
    o.rew = rew;
  }

  float new_step;
  const bool done_pre = done;
  done = step_stats(r.st, r.step_f, P.max_steps, rew, violf, done, new_step);
  if constexpr (REC) {
    o.done = done;
    o.trunc = done && !done_pre;  // the time limit alone ended the episode
  }
  // Masked auto-reset from the counter stream: slots 0..2 inertia, 3..6
  // initial state, 7 impulse offset (cartpole._reset_core).
  if (done) {
    const uint32_t base = episode_base(r.seed_bits, static_cast<uint32_t>(static_cast<int>(r.ep) + 1));
#pragma unroll
    for (int k = 0; k < cp::NX; ++k) r.s[k] = P.rand_a[3 + k] + slot_uniform(base, 3 + k) * P.rand_b[3 + k];
    r.pl = P.rand_a[0] + slot_uniform(base, 0) * P.rand_b[0];
    r.pm = P.rand_a[1] + slot_uniform(base, 1) * P.rand_b[1];
    r.cm = P.rand_a[2] + slot_uniform(base, 2) * P.rand_b[2];
    r.offset = floorf(slot_uniform(base, 7) * P.max_steps);
    new_step = 0.0f;
    r.ep = r.ep + 1.0f;
  }
  r.step_f = new_step;
}

// ---------------------------------------------------------------------------
// Planar quadrotor (K7).
// ---------------------------------------------------------------------------

// What the step's derivative holds fixed: the thrust sum, 1/mass and the
// 2D quad's theta_dd.
struct PlanarBody {
  float Tsum, minv, theta_dd;
};

// The body from the motor forces fm and the env's mass and iyy: 1/mass and
// the first division of theta_dd side by side, then theta_dd's second.
// Every lane of the warp calls it (it exchanges values).
template <int NX, int NU, int G>
__device__ __forceinline__ PlanarBody planar_body(const pq::PlanarParams& P, const float* fm,
                                                  float mass, float iyy, const LaneGroup& g) {
  PlanarBody b;
  if constexpr (NX == 2) {
    b.Tsum = (fm[0] + fm[0]) + fm[0] + fm[0];  // 4 motors, one command
    b.minv = 1.0f / mass;
    b.theta_dd = 0.0f;
  } else {
    const float T1 = fm[0] + fm[0], T2 = fm[1] + fm[1];  // motors (T1, T2, T2, T1)
    b.Tsum = T1 + T2;
    const float num[2] = {1.0f, P.arm_l * (T2 - T1)};
    const float den[2] = {mass, iyy};
    float q[2];
    div_round<G, 2>(num, den, q, g);
    b.minv = q[0];
    b.theta_dd = q[1] / P.sqrt2;
  }
  return b;
}

// quad_fc_2d's derivative with the sine and cosine of sv[4] given.
__device__ __forceinline__ void fc_2d(const float* sv, float sn, float cs, const PlanarBody& b,
                                      float ext, float g_, float* d) {
  d[0] = sv[1];
  d[1] = sn * b.Tsum * b.minv + ext * b.minv;
  d[2] = sv[3];
  d[3] = cs * b.Tsum * b.minv - g_ + ext * b.minv;
  d[4] = sv[5];
  d[5] = b.theta_dd;
}

// The substep loop of a planar-quad step (quad_fc_1d / quad_fc_2d) on s in
// place.
// 2D: the angles of a substep's four RK4 stage evaluations, or of G Euler
// substeps, are computed ahead from (theta, theta_dot) alone, by the adds
// and multiplies that the substeps do on them, and their sincosf run one a
// lane (in turns where there are more angles than lanes); the substeps then
// take the sines and cosines in order.
template <int NX, int G>
__device__ __forceinline__ void planar_substeps(const pq::PlanarParams& P, float* s,
                                                const PlanarBody& b, float ext, const LaneGroup& g) {
  float k1[NX], k2[NX], k3[NX], k4[NX], t[NX];
  if constexpr (NX == 2) {
    auto fc = [&](const float* sv, float* d) {
      d[0] = sv[1];
      d[1] = b.Tsum * b.minv - P.g + ext * b.minv;
    };
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
  } else if (P.euler) {
    for (int n0 = 0; n0 < P.n_sub; n0 += G) {
      // Angle j of the round is substep n0 + j's.
      float ang[G], sn[G], cs[G];
      float a = s[4], w = s[5];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        ang[j] = a;
        a = a + P.dt * w;
        w = w + P.dt * b.theta_dd;
      }
      sincos_round<G, G>(ang, sn, cs, g);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (n0 + j < P.n_sub) {
          fc_2d(s, sn[j], cs[j], b, ext, P.g, k1);
#pragma unroll
          for (int i = 0; i < NX; ++i) s[i] = s[i] + P.dt * k1[i];
        }
      }
    }
  } else {
    for (int n = 0; n < P.n_sub; ++n) {
      // Angle m is stage m's of this substep.
      float ang[4], sn[4], cs[4];
      const float a = s[4], w = s[5];
      const float w2 = w + P.dt_half * b.theta_dd;
      ang[0] = a;
      ang[1] = a + P.dt_half * w;
      ang[2] = a + P.dt_half * w2;
      ang[3] = a + P.dt * w2;
      sincos_round<G, 4>(ang, sn, cs, g);
      fc_2d(s, sn[0], cs[0], b, ext, P.g, k1);
#pragma unroll
      for (int i = 0; i < NX; ++i) t[i] = s[i] + P.dt_half * k1[i];
      fc_2d(t, sn[1], cs[1], b, ext, P.g, k2);
#pragma unroll
      for (int i = 0; i < NX; ++i) t[i] = s[i] + P.dt_half * k2[i];
      fc_2d(t, sn[2], cs[2], b, ext, P.g, k3);
#pragma unroll
      for (int i = 0; i < NX; ++i) t[i] = s[i] + P.dt * k3[i];
      fc_2d(t, sn[3], cs[3], b, ext, P.g, k4);
#pragma unroll
      for (int i = 0; i < NX; ++i)
        s[i] = s[i] + P.dt_sixth * (k1[i] + 2.0f * k2[i] + 2.0f * k3[i] + k4[i]);
    }
  }
}

// The motor forces a group holds: slot k = q G + gl of lane gl's round q is
// input k % NU at step k / NU of a run of S steps (one step's NU inputs
// take R rounds where the group has fewer lanes than inputs).
template <int NU, int G>
struct ForceSlots {
  static constexpr int S = G >= NU ? G / NU : 1;
  static constexpr int R = G >= NU ? 1 : NU / G;
  static_assert(G >= NU ? G % NU == 0 : NU % G == 0, "slots fill whole rounds");
  float f[R];
};

// The realized forces of a constant command thr (no action noise): slot
// q G + gl holds input (q G + gl) % NU's.
template <int NU, int G>
__device__ __forceinline__ void constant_forces(const pq::PlanarParams& P, const float (&thr)[NU],
                                                ForceSlots<NU, G>& fs, const LaneGroup& g) {
#pragma unroll
  for (int q = 0; q < ForceSlots<NU, G>::R; ++q)
    fs.f[q] = pq::actuate(pick<NU>(thr, (q * G + g.gl) % NU), P.n_motor);
}

// One input's realized motor force a lane, in rounds of G lanes: fm[i] =
// actuate(t[i]) for i < NU on every lane.
template <int NU, int G>
__device__ __forceinline__ void actuate_round(const pq::PlanarParams& P, const float (&t)[NU],
                                              float (&fm)[NU], const LaneGroup& g) {
#pragma unroll
  for (int r0 = 0; r0 < NU; r0 += G) {
    float x = t[r0];
#pragma unroll
    for (int i = 1; i < G && r0 + i < NU; ++i) x = g.gl >= i ? t[r0 + i] : x;
    const float f = pq::actuate(x, P.n_motor);
#pragma unroll
    for (int i = 0; i < G && r0 + i < NU; ++i) fm[r0 + i] = from<G>(f, g, i);
  }
}

// The goal rows at control step step_f (fast_quad_planar.py::goal_rows):
// the static goal, or the closed-form curve on the axes the state reads
// (1D: z; 2D: x and z).  Also the goal-horizon rows of K8's observation
// instance (obs_ext.cuh).
template <int NX>
__device__ __forceinline__ void planar_goal(const pq::PlanarParams& P, float step_f, float* goal) {
  if (P.task == 0) {
#pragma unroll
    for (int k = 0; k < NX; ++k) goal[k] = P.x_goal[k];
  } else {
    float sw, cw;
    sincosf(curve_angle(P.curve, P.ctrl_dt, step_f), &sw, &cw);
    if constexpr (NX == 2) {
      axis_goal_sc(P.curve, P.plane_off, P.ctrl_dt, step_f, P.z_sel, sw, cw, goal[0], goal[1]);
    } else {
      axis_goal_sc(P.curve, P.plane_off, P.ctrl_dt, step_f, P.x_sel, sw, cw, goal[0], goal[1]);
      axis_goal_sc(P.curve, P.plane_off, P.ctrl_dt, step_f, P.z_sel, sw, cw, goal[2], goal[3]);
      goal[4] = goal[5] = 0.0f;
    }
  }
}

// One planar-quad control step in place on r over the group (the JAX
// package's step_env_core, fast_quad_planar.py:161-336): action white
// noise, motor-grouped actuation, impulse, RK4 or Euler substeps, goal,
// violation, reward, done and the non-finite freeze, statistics,
// counter-PRNG auto-reset.  thr_pre: the preprocessed thrusts (pre noise);
// act: the commanded action.
//
// A constant command (K7): the body b is held from an earlier step and made
// again where the noise moved the forces or an env of the warp was reset
// (fresh, the previous step's return).  fs holds the group's motor forces
// (ForceSlots), with action noise redrawn for the next S steps when
// it % S == 0.
//
// POLICY (K8): the command changes every step.  fs holds the action-noise
// terms of the next S steps (drawn when it % S == 0, state-free); the step
// adds this step's terms to its thrusts, actuates them one input a lane and
// makes b; fresh is not read.  o receives the step's reward, done and
// truncation flags and the state after the freeze, before the reset;
// without POLICY, o is not written.  Returns the done flag (the env was
// reset).
template <int NX, int NU, int G, bool POLICY = false>
__device__ __forceinline__ bool pq_step(const pq::PlanarParams& P, pq::Rows<NX>& r,
                                        const float (&thr_pre)[NU], const float (&act)[NU], int it,
                                        uint32_t seed, ForceSlots<NU, G>& fs, bool fresh,
                                        PlanarBody& b, const LaneGroup& g, pq::StepOut<NX>& o) {
  using FS = ForceSlots<NU, G>;
  float act_err[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) act_err[i] = thr_pre[i] - P.u_goal;
  if constexpr (POLICY) {
    float t[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) t[i] = thr_pre[i];
    if (P.act_noise) {
      if (it % FS::S == 0) {
#pragma unroll
        for (int q = 0; q < FS::R; ++q) {
          const int k = q * G + g.gl;
          fs.f[q] = noise_term<NU>(g.e, it + k / NU, k % NU, seed, P.act_noise_std);
        }
      }
      const int src = (it % FS::S) * NU;  // the slot of this step's input 0
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        if constexpr (FS::R == 1) {
          t[i] = t[i] + from<G>(fs.f[0], g, src + i);
        } else {
          t[i] = t[i] + from<G>(fs.f[i / G], g, i % G);
        }
      }
    }
    float fm[NU];
    actuate_round<NU, G>(P, t, fm, g);
    b = planar_body<NX, NU, G>(P, fm, r.mass, r.iyy, g);
  } else {
    int src = 0;  // the slot of this step's input 0
    if (P.act_noise) {
      if (it % FS::S == 0) {
#pragma unroll
        for (int q = 0; q < FS::R; ++q) {
          const int k = q * G + g.gl, i = k % NU;
          fs.f[q] = pq::actuate(
              pick<NU>(thr_pre, i) + noise_term<NU>(g.e, it + k / NU, i, seed, P.act_noise_std),
              P.n_motor);
        }
      }
      src = (it % FS::S) * NU;
    }
    // A new body where the noise moved the forces, or (warp-wide, since it
    // exchanges values) where an env of the warp was reset.
    if (P.act_noise || __any_sync(FULL_MASK, fresh)) {
      float fm[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        if constexpr (FS::R == 1) {
          fm[i] = from<G>(fs.f[0], g, src + i);
        } else {
          fm[i] = from<G>(fs.f[i / G], g, i % G);
        }
      }
      b = planar_body<NX, NU, G>(P, fm, r.mass, r.iyy, g);
    }
  }
  const float ext = P.impulse ? cp::impulse_force(r.step_f, r.offset, P.imp_peak_shift, P.imp_half_dur,
                                                  P.decay_one, P.imp_log_decay, P.imp_mag)
                              : 0.0f;
  float s[NX];
#pragma unroll
  for (int k = 0; k < NX; ++k) s[k] = r.s[k];
  planar_substeps<NX, G>(P, s, b, ext, g);

  float goal[NX];
  planar_goal<NX>(P, r.step_f, goal);

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
  if constexpr (POLICY) {
#pragma unroll
    for (int k = 0; k < NX; ++k) o.s_post[k] = r.s[k];
    o.rew = rew;
  }

  float new_step;
  const bool done_pre = done;
  done = step_stats(r.st, r.step_f, P.max_steps, rew, violf, done, new_step);
  if constexpr (POLICY) {
    o.done = done;
    o.trunc = done && !done_pre;  // the time limit alone ended the episode
  }
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
  return done;
}

}  // namespace grp
}  // namespace scg
