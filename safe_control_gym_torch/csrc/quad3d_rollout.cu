// K2: whole constant-action rollout of the 3D quadrotor, many control steps
// per launch.
//
// Replaces safe_control_gym_tpu/parallel/fast_env.py::_rollout_kernel (and
// the non-maze path of its step_env_core): per control step, action clip,
// actuation, impulse dynamics force, RK4/Euler substeps, the closed-form
// goal (eval_goal / eval_curve), box-constraint violation, out-of-bound
// done, rl_reward or quadratic reward, goal-capture done, time limit, the
// 7 episode-statistic rows, and the counter-PRNG auto-reset (slot remap of
// fast_env.py:540).
//
// Layout: state rows (27, B) with row r of env b at r*B + b, at the JAX
// package's row indices (fast_env.py:48-57); action (4, B).  The TPU's
// (rows, 8, B/8) tiling is dropped: consecutive threads read consecutive
// addresses of each row, so every load and store coalesces.
//
// Design: one thread per env, all 27 rows in registers for the whole call,
// a loop over `steps` inside the thread in place of the TPU's fori_loop.
// Device memory is touched once in and once out per call.  The env seed row
// (25) is a float32 bit pattern (some seeds are NaN patterns): it is read
// and written as uint32 and never takes part in float arithmetic.
//
// Bound on an H100: arithmetic.  At B = 4096 and 8192 steps a call moves
// under 1 MB but does ~2.3k f32 ops and ~135 transcendentals per env-step
// (~77 GFLOP), about 1.2 ms at the card's 67 TFLOP/s f32 peak.  That peak
// needs every SM's four schedulers busy; B = 4096 threads are 128 warps,
// under one warp per SM, so a call runs at a small share of it and the
// dependent chain of each thread's step sets the time.  More envs per
// launch, or several envs per thread for instruction-level parallelism, is
// later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "quad3d.cuh"

namespace {

// Row indices (fast_env.py:48-57).
constexpr int R_MASS = 12, R_J = 13, R_STEP = 16, R_OFFSET = 17, R_STATS = 18;
constexpr int R_SEED = 25, R_EP = 26, NROWS = 27;

// Static engine parameters, passed by value.  Mirrored field for field by
// safe_control_gym_torch/parallel/fast_env.py::RolloutParams; every float
// is the float32 rounding of the expression the plain version evaluates.
struct RolloutParams {
  int steps, n_sub, euler;
  int cost;       // 0 rl_reward, 1 quadratic
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
    for (int k = 0; k < scg::NX; ++k) goal[k] = P.x_goal[k];
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
  for (int k = 6; k < scg::NX; ++k) goal[k] = 0.0f;
}

__global__ void quad3d_rollout_kernel(const RolloutParams P, const float* __restrict__ rows_in,
                                      const float* __restrict__ action, float* __restrict__ rows_out,
                                      int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  float s[scg::NX];
#pragma unroll
  for (int k = 0; k < scg::NX; ++k) s[k] = rows_in[k * B + e];
  float mass = rows_in[R_MASS * B + e];
  float jd[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) jd[i] = rows_in[(R_J + i) * B + e];
  float step_f = rows_in[R_STEP * B + e];
  float offset = rows_in[R_OFFSET * B + e];
  float st[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) st[i] = rows_in[(R_STATS + i) * B + e];
  const uint32_t seed_bits = reinterpret_cast<const uint32_t*>(rows_in)[R_SEED * B + e];
  float ep = rows_in[R_EP * B + e];

  // The action is constant over the call: clip, action cost and actuation
  // are the same every step.
  float act[4], thr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    act[i] = action[i * B + e];
    thr[i] = scg::clipf(act[i], P.a_low, P.a_high);
  }
  float act_cost, quad_act;
  {
    const float e0 = thr[0] - P.u_goal, e1 = thr[1] - P.u_goal;
    const float e2 = thr[2] - P.u_goal, e3 = thr[3] - P.u_goal;
    act_cost = (e0 * e0 + e1 * e1 + e2 * e2 + e3 * e3) * P.rew_act_w;
    quad_act = P.r_half[0] * (e0 * e0) + P.r_half[1] * (e1 * e1) + P.r_half[2] * (e2 * e2) +
               P.r_half[3] * (e3 * e3);
  }
  bool u_viol = false;
  if (P.u_check) {
#pragma unroll
    for (int i = 0; i < 4; ++i) u_viol = u_viol || (act[i] < P.u_low[i]) || (act[i] > P.u_high[i]);
  }
  scg::Body b;
#pragma unroll
  for (int i = 0; i < 4; ++i) b.f[i] = scg::actuate(thr[i]);
  b.g = P.g;
  b.l_sq2 = P.l_sq2;
  b.km_over_kf = P.km_over_kf;

  for (int it = 0; it < P.steps; ++it) {
    // Dynamics disturbance: impulse schedule (fast_env.py:356-366).
    float n = 0.0f;
    if (P.impulse) {
      const float peak = offset + P.imp_peak_shift;
      const float po = fabsf(step_f - peak);
      const float dec = po < P.imp_half_dur ? (P.decay_one ? 1.0f : expf(po * P.imp_log_decay)) : 0.0f;
      n = step_f >= offset ? P.imp_mag * dec : 0.0f;
    }
    b.ext[0] = b.ext[1] = b.ext[2] = n;
    b.minv = 1.0f / mass;
    b.j[0] = jd[0];
    b.j[1] = jd[1];
    b.j[2] = jd[2];
    scg::substeps(s, b, P.n_sub, P.euler, P.dt, P.dt_half, P.dt_sixth);

    float goal[scg::NX];
    eval_goal(P, step_f, goal);

    // Violation (constraint box) and out-of-bound done (env-space box).
    bool viol = u_viol, oob = false;
#pragma unroll
    for (int k = 0; k < scg::NX; ++k) {
      viol = viol || (s[k] < P.c_low[k]) || (s[k] > P.c_high[k]);
      if (P.done_oob && P.oob_mask[k]) oob = oob || (s[k] < P.s_low[k]) || (s[k] > P.s_high[k]);
    }
    const float violf = (P.count_viol && viol) ? 1.0f : 0.0f;

    float rew;
    if (P.cost == 1) {
      float dist = quad_act;
#pragma unroll
      for (int k = 0; k < scg::NX; ++k) {
        const float d = s[k] - goal[k];
        dist = dist + P.q_half[k] * d * d;
      }
      rew = -dist;
    } else {
      float dist = act_cost;
#pragma unroll
      for (int k = 0; k < scg::NX; ++k) {
        const float d = s[k] - goal[k];
        dist = dist + P.rew_state_w[k] * d * d;
      }
      rew = P.rew_exp ? expf(-dist) : -dist;
    }

    float new_step = step_f + 1.0f;
    const bool timeout = new_step >= P.max_steps;
    bool done = oob;
    if (P.cost == 1 && P.task == 0) {
      // Goal capture (quadrotor.py:907-910).
      float d2 = 0.0f;
#pragma unroll
      for (int k = 0; k < scg::NX; ++k) {
        const float d = s[k] - goal[k];
        d2 = d2 + d * d;
      }
      done = done || (d2 < P.stab_tol2);
    }
    done = done || timeout;

    // Episode statistics.
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

    // Masked auto-reset from the counter stream: slots 4..15 initial state,
    // 0..3 inertia, 16 impulse offset (quadrotor._reset_core layout).
    if (done) {
      const uint32_t base =
          scg::episode_base(seed_bits, static_cast<uint32_t>(static_cast<int>(ep) + 1));
#pragma unroll
      for (int k = 0; k < scg::NX; ++k)
        s[k] = P.rand_a[4 + k] + scg::slot_uniform(base, 4 + k) * P.rand_b[4 + k];
      mass = P.rand_a[0] + scg::slot_uniform(base, 0) * P.rand_b[0];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        jd[i] = P.rand_a[1 + i] + scg::slot_uniform(base, 1 + i) * P.rand_b[1 + i];
      offset = floorf(scg::slot_uniform(base, 16) * P.max_steps);
      new_step = 0.0f;
      ep = ep + 1.0f;
    }
    step_f = new_step;
  }

#pragma unroll
  for (int k = 0; k < scg::NX; ++k) rows_out[k * B + e] = s[k];
  rows_out[R_MASS * B + e] = mass;
#pragma unroll
  for (int i = 0; i < 3; ++i) rows_out[(R_J + i) * B + e] = jd[i];
  rows_out[R_STEP * B + e] = step_f;
  rows_out[R_OFFSET * B + e] = offset;
#pragma unroll
  for (int i = 0; i < 7; ++i) rows_out[(R_STATS + i) * B + e] = st[i];
  reinterpret_cast<uint32_t*>(rows_out)[R_SEED * B + e] = seed_bits;
  rows_out[R_EP * B + e] = ep;
}

}  // namespace

// sizeof(RolloutParams), checked against the ctypes mirror at load time.
extern "C" int quad3d_rollout_params_size() { return static_cast<int>(sizeof(RolloutParams)); }

extern "C" int quad3d_rollout(const void* params, const void* rows_in, const void* action,
                              void* rows_out, int B, int block, void* stream) {
  const RolloutParams P = *static_cast<const RolloutParams*>(params);
  const int grid = (B + block - 1) / block;
  quad3d_rollout_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const float*>(rows_in), static_cast<const float*>(action),
      static_cast<float*>(rows_out), B);
  return static_cast<int>(cudaGetLastError());
}
