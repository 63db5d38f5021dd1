// Shared device functions of the 3D-quadrotor kernels (K1 quad3d_substeps,
// K2 quad3d_rollout, K3 quad3d_policy_rollout): the thrust -> force
// actuation pipeline, the rigid body's parameters, the counter-based reset
// hash, and the rest of the whole-rollout engines' control step after its
// substeps (env_step).  The rigid-body derivative and the substeps are
// lane_group.cuh's fc_group / substeps_group, which all three kernels run.
// The math functions, the actuation and the body are templates on the
// scalar type: K2, K3 and K1's float32 instances take float, K1's float64
// instances double.
//
// Every expression keeps the operand order of the JAX package's Pallas
// kernels (safe_control_gym_tpu/ops/pallas_quad.py::_fc_rows / _actuate,
// ops/ctr_prng.py) and of the plain PyTorch versions beside the wrappers
// (ops/quad_substeps.py, parallel/fast_env.py).  The library is compiled
// with -fmad=false, so each + and * rounds once, as the plain versions do.
#pragma once

#include <cstdint>

namespace scg {

// cf2x.urdf constants (envs/quadrotor.py).
constexpr float KF = 3.16e-10f;
constexpr float PWM2RPM_SCALE = 0.2685f;
constexpr float PWM2RPM_CONST = 4070.3f;
constexpr float MIN_PWM = 20000.0f;
constexpr float MAX_PWM = 65535.0f;
constexpr int NX = 12;  // [x, vx, y, vy, z, vz, phi, theta, psi, p, q, r]

// max/min that propagate NaN in their first operand, like torch.maximum /
// jnp.maximum (fmaxf would drop it).
__device__ __forceinline__ float maxp(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float minp(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float clipf(float a, float lo, float hi) { return minp(maxp(a, lo), hi); }
__device__ __forceinline__ double maxp(double a, double b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ double minp(double a, double b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ double clipf(double a, double lo, double hi) { return minp(maxp(a, lo), hi); }

// The float and double forms of the accurate math functions, so that one
// template serves both scalar types.  sincosf gives sinf's and cosf's bits,
// and sincos sin's and cos's (scripts/ab_kernel.py's checks against the
// one-thread builds that called them apart), from one range reduction: one
// convergence region, not two.
__device__ __forceinline__ void sincos_t(float a, float* s, float* c) { sincosf(a, s, c); }
__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ void sincos_t(double a, double* s, double* c) { sincos(a, s, c); }
__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }

// The motor constants in the scalar type T (the float ones are those
// above; the double ones are the same decimals, as the plain version's
// Python constants are).
template <typename T>
struct Motor;
template <>
struct Motor<float> {
  static constexpr float kf = KF, scale = PWM2RPM_SCALE, offset = PWM2RPM_CONST, lo = MIN_PWM,
                         hi = MAX_PWM;
};
template <>
struct Motor<double> {
  static constexpr double kf = 3.16e-10, scale = 0.2685, offset = 4070.3, lo = 20000.0, hi = 65535.0;
};

// Per-motor thrust command -> realized force: cmd2pwm -> clip -> pwm2rpm ->
// rpm^2 * KF (pallas_quad.py:98-106).  actuate_ratio takes the first
// division's quotient max(t, 0) / KF, so that K1's group can take another
// division beside it (quad3d_substeps.cu).
template <typename T>
__device__ __forceinline__ T actuate_ratio(T ratio) {
  using M = Motor<T>;
  T pwm = (sqrt_t(ratio) - M::offset) / M::scale;
  pwm = clipf(pwm, M::lo, M::hi);
  T rpm = M::scale * pwm + M::offset;
  return rpm * rpm * M::kf;
}

template <typename T>
__device__ __forceinline__ T actuate(T t) {
  return actuate_ratio(maxp(t, T(0)) / Motor<T>::kf);
}

// Rigid-body physics constants and per-env parameters of one control step.
template <typename T>
struct BodyT {
  T f[4];    // per-motor forces
  T ext[3];  // world-frame external force
  T minv;    // 1 / mass
  T j[3];    // inertia diagonal
  T g, l_sq2, km_over_kf;
};
using Body = BodyT<float>;

// Counter-based reset hash (ops/ctr_prng.py), native uint32 arithmetic.
constexpr uint32_t SLOT_GOLD = 0x9E3779B9u;
constexpr uint32_t EP_GOLD = 0x85EBCA6Bu;
constexpr uint32_t M1 = 0x7FEB352Du;
constexpr uint32_t M2 = 0x846CA68Bu;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= M1;
  x ^= x >> 15;
  x *= M2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t episode_base(uint32_t env_seed, uint32_t episode_idx) {
  return mix32(env_seed ^ mix32(episode_idx * EP_GOLD));
}

// One [0, 1) uniform for a static draw slot, from the low 24 bits.
__device__ __forceinline__ float slot_uniform(uint32_t base, uint32_t slot) {
  const uint32_t h = mix32(base + slot * SLOT_GOLD);
  return static_cast<float>(h & 0x00FFFFFFu) * 5.9604644775390625e-08f;  // 2^-24
}

// ---------------------------------------------------------------------------
// The whole-rollout engines' control step (K2 quad3d_rollout, K3
// quad3d_policy_rollout): the JAX package's step_env_core
// (safe_control_gym_tpu/parallel/fast_env.py:297-590); plain version
// parallel/fast_env.py::step_rows.  The maze and the step noise are the
// maze instances' of K2 and K3 (maze.cuh); their other instances compile
// them out.
// ---------------------------------------------------------------------------

// Row indices (fast_env.py:48-57).
constexpr int R_MASS = 12, R_J = 13, R_STEP = 16, R_OFFSET = 17, R_STATS = 18;
constexpr int R_SEED = 25, R_EP = 26, NROWS = 27;

// Static engine parameters, passed by value.  Mirrored field for field by
// safe_control_gym_torch/parallel/fast_env.py::RolloutParams; every float
// is the float32 rounding of the expression the plain version evaluates.
struct RolloutParams {
  int steps, n_sub, euler;
  int cost;       // 0 rl_reward, 1 quadratic, 2 competition
  int task;       // 0 stabilization, 1 trajectory
  int traj_type;  // 0 figure8, 1 circle, 2 square
  int impulse, decay_one, u_check, done_oob, count_viol, rew_exp;
  int plane_a, plane_b;
  int oob_mask[12];
  float dt, dt_half, dt_sixth, ctrl_dt, g, l_sq2, km_over_kf;
  float a_low, a_high, u_goal, rew_act_w, max_steps, stab_tol2;
  float imp_mag, imp_peak_shift, imp_half_dur, imp_log_decay;
  float traj_w, traj_scale, traj_neg_scale, traj_sc_w, traj_neg_sc_w;
  float traj_period, traj_seg_period, traj_speed, traj_neg_speed;
  float plane_off[2];
  float proj[12];  // 3x4 affine rows
  float x_goal[12], rew_state_w[12], q_half[12], r_half[4];
  float s_low[12], s_high[12], c_low[12], c_high[12], u_low[4], u_high[4];
  float rand_a[16], rand_b[16];  // reset affine: a + u * b, fast-row order
  // The maze envelope (maze.cuh), after the fields of the other instances,
  // so that their struct is a prefix of this one.
  int maze, n_gates, n_obst, act_noise, dyn_uniform, done_collision, done_completion;
  float act_noise_std, n_sub_f, settle, goal_tol, completion_steps;
  float dyn_lo[3], dyn_span[3], goal_xyz[3];
  float gate_h[8];                // nominal gate heights
  float pose_a[40], pose_b[40];  // pose reset affine: 3 a gate, then 2 an obstacle from 24
};

// The maze's counters (one row each) and one step's flags of its geometry
// (maze.cuh::maze_geometry_group), which env_step's reward, done and reset
// read.
struct MazeCounters {
  float cur_gate, steps_goal, completed, prev_viol;
  bool collided, stepped, at_goal;
};

// Closed-form planar reference curve at time t (fast_env.py:232-267).
__device__ __forceinline__ void eval_curve(const RolloutParams& P, float t, float& a_p, float& b_p,
                                           float& a_v, float& b_v) {
  if (P.traj_type == 0) {  // figure8
    const float wt = P.traj_w * t;
    const float sw = sinf(wt), cw = cosf(wt);
    a_p = P.traj_scale * sw;
    b_p = P.traj_scale * sw * cw;
    a_v = P.traj_sc_w * cw;
    b_v = P.traj_sc_w * (cw * cw - sw * sw);
  } else if (P.traj_type == 1) {  // circle
    const float wt = P.traj_w * t;
    const float sw = sinf(wt), cw = cosf(wt);
    a_p = P.traj_scale * cw;
    b_p = P.traj_scale * sw;
    a_v = P.traj_neg_sc_w * sw;
    b_v = P.traj_sc_w * cw;
  } else {  // square: piecewise-linear perimeter
    const float cyc = t - P.traj_period * floorf(t / P.traj_period);
    const float seg = floorf(cyc / P.traj_seg_period);
    const float seg_pos = P.traj_speed * (cyc - seg * P.traj_seg_period);
    const bool is0 = seg < 0.5f;
    const bool is1 = fabsf(seg - 1.0f) < 0.5f;
    const bool is2 = fabsf(seg - 2.0f) < 0.5f;
    const float zt = 0.0f;
    a_p = is0 ? zt : is1 ? -seg_pos : is2 ? P.traj_neg_scale + zt : P.traj_neg_scale + seg_pos;
    b_p = is0 ? seg_pos : is1 ? P.traj_scale + zt : is2 ? P.traj_scale - seg_pos : zt;
    a_v = is0 ? zt : is1 ? P.traj_neg_speed + zt : is2 ? zt : P.traj_speed + zt;
    b_v = is0 ? P.traj_speed + zt : is1 ? zt : is2 ? P.traj_neg_speed + zt : zt;
  }
}

// Goal rows at control step step_f (fast_env.py:270-294).
__device__ __forceinline__ void eval_goal(const RolloutParams& P, float step_f, float* goal) {
  if (P.task == 0) {
#pragma unroll
    for (int k = 0; k < NX; ++k) goal[k] = P.x_goal[k];
    return;
  }
  const float t = step_f * P.ctrl_dt;
  float a_p, b_p, a_v, b_v;
  eval_curve(P, t, a_p, b_p, a_v, b_v);
  float p3[3] = {0.0f, 0.0f, 0.0f}, v3[3] = {0.0f, 0.0f, 0.0f};
  p3[P.plane_a] = a_p + P.plane_off[0];
  p3[P.plane_b] = b_p + P.plane_off[1];
  v3[P.plane_a] = a_v;
  v3[P.plane_b] = b_v;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* M = P.proj + 4 * k;
    goal[2 * k] = M[0] * p3[0] + M[1] * p3[1] + M[2] * p3[2] + M[3];
    goal[2 * k + 1] = M[0] * v3[0] + M[1] * v3[1] + M[2] * v3[2] + M[3];
  }
#pragma unroll
  for (int k = 6; k < NX; ++k) goal[k] = 0.0f;
}

// One env's 27 state rows, held in registers for a whole call.  The env
// seed row (25) is a float32 bit pattern (some seeds are NaN patterns): it
// is read and written as uint32 and never takes part in float arithmetic.
struct EnvRows {
  float s[NX];
  float mass, jd[3], step_f, offset, st[7], ep;
  uint32_t seed_bits;
};

// Rows (27, B): row r of env e at r*B + e.
__device__ __forceinline__ void load_rows(const float* __restrict__ rows, int B, int e, EnvRows& r) {
#pragma unroll
  for (int k = 0; k < NX; ++k) r.s[k] = rows[k * B + e];
  r.mass = rows[R_MASS * B + e];
#pragma unroll
  for (int i = 0; i < 3; ++i) r.jd[i] = rows[(R_J + i) * B + e];
  r.step_f = rows[R_STEP * B + e];
  r.offset = rows[R_OFFSET * B + e];
#pragma unroll
  for (int i = 0; i < 7; ++i) r.st[i] = rows[(R_STATS + i) * B + e];
  r.seed_bits = reinterpret_cast<const uint32_t*>(rows)[R_SEED * B + e];
  r.ep = rows[R_EP * B + e];
}

__device__ __forceinline__ void store_rows(float* __restrict__ rows, int B, int e, const EnvRows& r) {
#pragma unroll
  for (int k = 0; k < NX; ++k) rows[k * B + e] = r.s[k];
  rows[R_MASS * B + e] = r.mass;
#pragma unroll
  for (int i = 0; i < 3; ++i) rows[(R_J + i) * B + e] = r.jd[i];
  rows[R_STEP * B + e] = r.step_f;
  rows[R_OFFSET * B + e] = r.offset;
#pragma unroll
  for (int i = 0; i < 7; ++i) rows[(R_STATS + i) * B + e] = r.st[i];
  reinterpret_cast<uint32_t*>(rows)[R_SEED * B + e] = r.seed_bits;
  rows[R_EP * B + e] = r.ep;
}

// What a step needs of its action: the realized motor forces, the reward's
// action terms on the preprocessed thrust, and the input-constraint test on
// the raw action (step_env_core :332-349, :461-466).
struct ActionTerms {
  float f[4];
  float act_cost, quad_act;
  bool u_viol;
};

__device__ __forceinline__ ActionTerms action_terms(const RolloutParams& P, const float* thr,
                                                    const float* act) {
  ActionTerms a;
  const float e0 = thr[0] - P.u_goal, e1 = thr[1] - P.u_goal;
  const float e2 = thr[2] - P.u_goal, e3 = thr[3] - P.u_goal;
  a.act_cost = (e0 * e0 + e1 * e1 + e2 * e2 + e3 * e3) * P.rew_act_w;
  a.quad_act = P.r_half[0] * (e0 * e0) + P.r_half[1] * (e1 * e1) + P.r_half[2] * (e2 * e2) +
               P.r_half[3] * (e3 * e3);
  a.u_viol = false;
  if (P.u_check) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a.u_viol = a.u_viol || (act[i] < P.u_low[i]) || (act[i] > P.u_high[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) a.f[i] = actuate(thr[i]);
  return a;
}

// What a step reports besides the new rows: reward, done (time limit
// included), truncation (time limit without another done), the violation
// flag, and the post-step state before the auto-reset (the terminal
// observation).
struct StepOut {
  float rew, violf;
  bool done, trunc;
  float s_post[NX];
};

// The rest of one control step in place on r (step_env_core), on the state
// that the step's substeps left: goal, violation, reward, done, statistics,
// auto-reset.  K2 and K3 run the whole step as
// lane_group.cuh::env_step_group, which runs the step noise, the dynamics
// force and the substeps over the group (and in MAZE, the maze's geometry
// into mc) and then this.  MAZE adds the competition reward, collision and
// completion done, and the counters' reset (the poses' redraw is the
// group's, maze.cuh::redraw_maze).
template <bool MAZE = false>
__device__ __forceinline__ void env_step(const RolloutParams& P, EnvRows& r, const ActionTerms& a,
                                         StepOut& o, MazeCounters& mc) {
#pragma unroll
  for (int k = 0; k < NX; ++k) o.s_post[k] = r.s[k];

  float goal[NX];
  eval_goal(P, r.step_f, goal);

  // Violation (constraint box) and out-of-bound done (env-space box).
  bool viol = a.u_viol, oob = false;
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    viol = viol || (r.s[k] < P.c_low[k]) || (r.s[k] > P.c_high[k]);
    if (P.done_oob && P.oob_mask[k]) oob = oob || (r.s[k] < P.s_low[k]) || (r.s[k] > P.s_high[k]);
  }
  o.violf = (P.count_viol && viol) ? 1.0f : 0.0f;

  if (MAZE && P.cost == 2) {
    // The sparse competition reward; its violation term is the previous
    // step's flag (fast_env.py:470-476).
    o.rew = 100.0f * (mc.stepped ? 1.0f : 0.0f) + 100.0f * (mc.at_goal ? 1.0f : 0.0f) -
            1000.0f * (mc.collided ? 1.0f : 0.0f) - 100.0f * mc.prev_viol;
  } else if (P.cost == 1) {
    float dist = a.quad_act;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const float d = r.s[k] - goal[k];
      dist = dist + P.q_half[k] * d * d;
    }
    o.rew = -dist;
  } else {
    float dist = a.act_cost;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const float d = r.s[k] - goal[k];
      dist = dist + P.rew_state_w[k] * d * d;
    }
    o.rew = P.rew_exp ? expf(-dist) : -dist;
  }

  float new_step = r.step_f + 1.0f;
  const bool timeout = new_step >= P.max_steps;
  bool done = oob;
  if (P.cost == 1 && P.task == 0) {
    // Goal capture (quadrotor.py:907-910).
    float d2 = 0.0f;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const float d = r.s[k] - goal[k];
      d2 = d2 + d * d;
    }
    done = done || (d2 < P.stab_tol2);
  }
  if (MAZE && P.maze) {
    if (P.done_collision) done = done || mc.collided;
    if (P.done_completion) done = done || (mc.completed > 0.5f);
  }
  o.trunc = timeout && !done;  // fast_env.py:509, before the time limit joins done
  done = done || timeout;
  o.done = done;

  // Episode statistics.
  const float donef = done ? 1.0f : 0.0f;
  const float ep_ret = r.st[0] + o.rew;
  const float ep_len = r.st[1] + 1.0f;
  const float ep_vio = r.st[2] + o.violf;
  r.st[0] = ep_ret * (1.0f - donef);
  r.st[1] = ep_len * (1.0f - donef);
  r.st[2] = ep_vio * (1.0f - donef);
  r.st[3] = r.st[3] + donef;
  r.st[4] = r.st[4] + donef * ep_ret;
  r.st[5] = r.st[5] + donef * ep_len;
  r.st[6] = r.st[6] + donef * ep_vio;

  // Masked auto-reset from the counter stream: slots 4..15 initial state,
  // 0..3 inertia, 16 impulse offset (quadrotor._reset_core layout).
  if (done) {
    const uint32_t base = episode_base(r.seed_bits, static_cast<uint32_t>(static_cast<int>(r.ep) + 1));
#pragma unroll
    for (int k = 0; k < NX; ++k) r.s[k] = P.rand_a[4 + k] + slot_uniform(base, 4 + k) * P.rand_b[4 + k];
    r.mass = P.rand_a[0] + slot_uniform(base, 0) * P.rand_b[0];
#pragma unroll
    for (int i = 0; i < 3; ++i) r.jd[i] = P.rand_a[1 + i] + slot_uniform(base, 1 + i) * P.rand_b[1 + i];
    r.offset = floorf(slot_uniform(base, 16) * P.max_steps);
    new_step = 0.0f;
    r.ep = r.ep + 1.0f;
    if (MAZE) {
      mc.cur_gate = 0.0f;
      mc.steps_goal = 0.0f;
      mc.completed = 0.0f;
    }
  }
  r.step_f = new_step;
  if (MAZE) mc.prev_viol = o.violf;  // the next step's "previous violation" flag
}

}  // namespace scg
