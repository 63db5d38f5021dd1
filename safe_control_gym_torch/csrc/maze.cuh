// The maze envelope of K2 and K3 (BASELINE config 5): the competition
// maze's gates and obstacles over a lane group, and the per-step noise of
// the maze family (action white noise, the uniform dynamics force).  The
// JAX package's step_env_core branch (safe_control_gym_tpu/parallel/
// fast_env.py:341-348, :367-370, :393-447, :560-588), which both its
// whole-rollout kernels run; plain version parallel/fast_env.py::step_rows
// / maze_geometry.  K3's group has 8 lanes, K2's 4: a lane past the last
// gate, obstacle or motor holds none but joins every ballot and shuffle.
//
// Layout of the lane group: lane gl holds gates gl, gl + G, ... and
// obstacles gl, gl + G, ... (their pose rows, and each gate's cos and sin
// of yaw, taken once a call and after each reset: a gate's yaw changes only
// on a reset), and every lane holds the four counters.  A step's collision
// tests and gate fans run on each lane's own gates and obstacles; the
// collision flags and the current gate's fan hit are joined over the group
// by a ballot (order-free: booleans).  Every other value is computed by the
// same float32 operations in the same order as the plain version (-fmad=
// false), so the kernel and the plain version agree bit for bit.
#pragma once

#include <cstdint>

#include "lane_group.cuh"
#include "philox.cuh"
#include "quad3d.cuh"

namespace scg {

constexpr int MAX_GATES = 8, MAX_OBSTACLES = 8;  // fast_env.py::MAX_GATES, MAX_OBSTACLES
constexpr int POSE_OBST = 3 * MAX_GATES;  // where the obstacles' pose affine begins in pose_a/b
static_assert(sizeof(RolloutParams::gate_h) == MAX_GATES * sizeof(float), "gate_h holds MAX_GATES");
static_assert(sizeof(RolloutParams::pose_a) == (3 * MAX_GATES + 2 * MAX_OBSTACLES) * sizeof(float),
              "pose_a holds 3 a gate and 2 an obstacle");

// envs/gates.py's dimensions.  Each threshold is the float rounding of its
// double sum or product, as the plain version's Python float meets a
// float32 row.
constexpr float GROUND_Z = 0.0125f;                          // GROUND_COLLISION_Z
constexpr float SLAB_R = static_cast<float>(0.025 + 0.06);   // GATE_SLAB_HALF + r
constexpr float OUTER_R = static_cast<float>(0.25 + 0.06);   // GATE_OUTER_HALF + r
constexpr float INNER_R = static_cast<float>(0.2 - 0.06);    // GATE_INNER_HALF - r
constexpr float OUTER_HALF = 0.25f;                          // GATE_OUTER_HALF
constexpr float LEG_R = static_cast<float>(0.05 + 0.06);     // OBSTACLE_RADIUS + r
constexpr float OBST_TOP = static_cast<float>(1.05 + 0.06);  // OBSTACLE_HEIGHT + r
constexpr float RAY_HALF = 0.1875f;                          // RAY_HALF_LENGTH
constexpr float RAY_R2 = static_cast<float>(0.06 * 0.06);    // r * r
constexpr int N_RAY = 3;                                     // N_RAY_OFFSETS

// i * RAY_SPACING, rounded once (a constant for each i of the unrolled fan).
__device__ __forceinline__ constexpr float ray_offset(int i) { return static_cast<float>(i * 0.05); }

// v[OFF + STRIDE i] for a run-time i < N, reading the parameter array only
// at constant indices (a run-time index into the by-value struct would copy
// it to local memory).
template <int N, int STRIDE, int OFF, int LEN>
__device__ __forceinline__ float param_at(const float (&v)[LEN], int i) {
  static_assert(OFF + STRIDE * (N - 1) < LEN, "inside the array");
  float r = v[OFF];
#pragma unroll
  for (int k = 1; k < N; ++k) r = i == k ? v[OFF + STRIDE * k] : r;
  return r;
}

// One lane's share of an env's maze: gates gl + G j and obstacles gl + G j
// (slots j), and the env's counters (every lane).
template <int G>
struct MazeRows {
  static constexpr int GS = (MAX_GATES + G - 1) / G, OS = (MAX_OBSTACLES + G - 1) / G;
  float gx[GS], gy[GS], gyaw[GS], gh[GS], gc[GS], gs[GS];  // gs, gc: sin and cos of the yaw
  float ox[OS], oy[OS];
  MazeCounters mc;
};

// Row of the counters: after 4 rows a gate and 2 an obstacle.
__device__ __forceinline__ int maze_counter_row(const RolloutParams& P) {
  return NROWS + 4 * P.n_gates + 2 * P.n_obst;
}

template <int G>
__device__ __forceinline__ void load_maze(const RolloutParams& P, const float* __restrict__ rows, int B,
                                          const LaneGroup& g, MazeRows<G>& m) {
#pragma unroll
  for (int j = 0; j < MazeRows<G>::GS; ++j) {
    const int gi = g.gl + G * j;
    const bool on = gi < P.n_gates;
    const int r0 = (NROWS + 4 * (on ? gi : 0)) * B + g.e;
    m.gx[j] = on ? rows[r0] : 0.0f;
    m.gy[j] = on ? rows[r0 + B] : 0.0f;
    m.gyaw[j] = on ? rows[r0 + 2 * B] : 0.0f;
    m.gh[j] = on ? rows[r0 + 3 * B] : 0.0f;
    sincosf(m.gyaw[j], &m.gs[j], &m.gc[j]);
  }
#pragma unroll
  for (int j = 0; j < MazeRows<G>::OS; ++j) {
    const int oi = g.gl + G * j;
    const bool on = oi < P.n_obst;
    const int r0 = (NROWS + 4 * P.n_gates + 2 * (on ? oi : 0)) * B + g.e;
    m.ox[j] = on ? rows[r0] : 0.0f;
    m.oy[j] = on ? rows[r0 + B] : 0.0f;
  }
  const int mz = maze_counter_row(P) * B + g.e;
  m.mc.cur_gate = rows[mz];
  m.mc.steps_goal = rows[mz + B];
  m.mc.completed = rows[mz + 2 * B];
  m.mc.prev_viol = rows[mz + 3 * B];
  m.mc.collided = m.mc.stepped = m.mc.at_goal = false;
}

// Each lane stores its own gates and obstacles; lane 0 the counters.
template <int G>
__device__ __forceinline__ void store_maze(const RolloutParams& P, float* __restrict__ rows, int B,
                                           const LaneGroup& g, const MazeRows<G>& m) {
#pragma unroll
  for (int j = 0; j < MazeRows<G>::GS; ++j) {
    const int gi = g.gl + G * j;
    if (gi < P.n_gates) {
      const int r0 = (NROWS + 4 * gi) * B + g.e;
      rows[r0] = m.gx[j];
      rows[r0 + B] = m.gy[j];
      rows[r0 + 2 * B] = m.gyaw[j];
      rows[r0 + 3 * B] = m.gh[j];
    }
  }
#pragma unroll
  for (int j = 0; j < MazeRows<G>::OS; ++j) {
    const int oi = g.gl + G * j;
    if (oi < P.n_obst) {
      const int r0 = (NROWS + 4 * P.n_gates + 2 * oi) * B + g.e;
      rows[r0] = m.ox[j];
      rows[r0 + B] = m.oy[j];
    }
  }
  if (g.gl == 0) {
    const int mz = maze_counter_row(P) * B + g.e;
    rows[mz] = m.mc.cur_gate;
    rows[mz + B] = m.mc.steps_goal;
    rows[mz + 2 * B] = m.mc.completed;
    rows[mz + 3 * B] = m.mc.prev_viol;
  }
}

// Whether any lane of the group holds v.
template <int G>
__device__ __forceinline__ bool group_any(bool v, const LaneGroup& g) {
  if constexpr (G == 1) {
    return v;
  } else if constexpr (G == 32) {
    return __any_sync(FULL_MASK, v);
  } else {
    return (__ballot_sync(FULL_MASK, v) & (((1u << G) - 1u) << g.base)) != 0u;
  }
}

// The maze's geometry on the post-substep state (fast_env.py:393-447):
// ground, gate-frame, gate-leg and obstacle collision, the current gate's
// 7-ray aperture fan, gate progress after the settling window, at-goal and
// completion.  Writes the step's flags and counters into m.mc.
template <int G>
__device__ __forceinline__ void maze_geometry_group(const RolloutParams& P, const EnvRows& r,
                                                    MazeRows<G>& m, const LaneGroup& g) {
  const float px = r.s[0], py = r.s[2], pz = r.s[4];
  bool coll = false, hit = false;
#pragma unroll
  for (int j = 0; j < MazeRows<G>::GS; ++j) {
    const int gi = g.gl + G * j;
    if (gi < P.n_gates) {
      const float c = m.gc[j], sn = m.gs[j], gx = m.gx[j], gy = m.gy[j], gh = m.gh[j];
      const float relx = px - gx, rely = py - gy;
      const float u = relx * c + rely * sn;
      const float nrm = -relx * sn + rely * c;
      const float wz = pz - gh;
      const bool in_slab = fabsf(nrm) < SLAB_R;
      const bool in_outer = (fabsf(u) < OUTER_R) && (fabsf(wz) < OUTER_R);
      const bool in_inner = (fabsf(u) < INNER_R) && (fabsf(wz) < INNER_R);
      const bool leg = (sqrtf(relx * relx + rely * rely) < LEG_R) && (pz < gh - OUTER_HALF);
      coll = coll || (in_slab && in_outer && !in_inner) || leg;
      // The 7-ray aperture fan, on every gate a lane holds; the current
      // gate's hit is kept.
      const float dz = clipf(pz, gh - RAY_HALF, gh + RAY_HALF) - pz;
      bool hit_g = false;
#pragma unroll
      for (int i = -N_RAY; i <= N_RAY; ++i) {
        const float sx = gx + ray_offset(i) * c;
        const float sy = gy + ray_offset(i) * sn;
        const float d2 = (px - sx) * (px - sx) + (py - sy) * (py - sy) + dz * dz;
        hit_g = hit_g || (d2 < RAY_R2);
      }
      hit = fabsf(m.mc.cur_gate - static_cast<float>(gi)) < 0.5f ? hit_g : hit;
    }
  }
#pragma unroll
  for (int j = 0; j < MazeRows<G>::OS; ++j) {
    if (g.gl + G * j < P.n_obst) {
      const float relx = px - m.ox[j], rely = py - m.oy[j];
      coll = coll || ((sqrtf(relx * relx + rely * rely) < LEG_R) && (pz < OBST_TOP));
    }
  }
  // Every lane joins both ballots (no short circuit before them).
  const bool coll_any = group_any<G>(coll, g);
  hit = group_any<G>(hit, g);
  MazeCounters& mc = m.mc;
  mc.collided = (pz < GROUND_Z) || coll_any;
  // Gate progress after the settling window (quadrotor.py:1060).
  const float n_g = static_cast<float>(P.n_gates);
  const bool active = (r.step_f * P.n_sub_f > P.settle) && (mc.cur_gate < n_g);
  mc.stepped = active && hit;
  mc.cur_gate = mc.cur_gate + (mc.stepped ? 1.0f : 0.0f);
  const float dx = px - P.goal_xyz[0], dy = py - P.goal_xyz[1], dzg = pz - P.goal_xyz[2];
  const bool near = sqrtf(dx * dx + dy * dy + dzg * dzg) < P.goal_tol;
  mc.at_goal = (mc.cur_gate >= n_g) && near;
  mc.steps_goal = mc.at_goal ? mc.steps_goal + 1.0f : 0.0f;
  mc.completed = maxp(mc.completed, mc.steps_goal > P.completion_steps ? 1.0f : 0.0f);
}

// After an auto-reset: this lane's gates and obstacles redrawn from counter
// slots 17 + 3 gi + c and 17 + 3 NG + 2 oi + c (the reset affine of
// fast_env.py::pose_affine: a + u * b), the gates at their nominal
// heights, and the new yaws' cos and sin.
template <int G>
__device__ __forceinline__ void redraw_maze(const RolloutParams& P, const EnvRows& r, MazeRows<G>& m,
                                            const LaneGroup& g) {
  const uint32_t base = episode_base(r.seed_bits, static_cast<uint32_t>(static_cast<int>(r.ep)));
#pragma unroll
  for (int j = 0; j < MazeRows<G>::GS; ++j) {
    const int gi = g.gl + G * j;
    if (gi < P.n_gates) {
      const uint32_t slot = 17u + 3u * static_cast<uint32_t>(gi);
      m.gx[j] = param_at<MAX_GATES, 3, 0>(P.pose_a, gi) +
                slot_uniform(base, slot) * param_at<MAX_GATES, 3, 0>(P.pose_b, gi);
      m.gy[j] = param_at<MAX_GATES, 3, 1>(P.pose_a, gi) +
                slot_uniform(base, slot + 1u) * param_at<MAX_GATES, 3, 1>(P.pose_b, gi);
      m.gyaw[j] = param_at<MAX_GATES, 3, 2>(P.pose_a, gi) +
                  slot_uniform(base, slot + 2u) * param_at<MAX_GATES, 3, 2>(P.pose_b, gi);
      m.gh[j] = param_at<MAX_GATES, 1, 0>(P.gate_h, gi);
      sincosf(m.gyaw[j], &m.gs[j], &m.gc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < MazeRows<G>::OS; ++j) {
    const int oi = g.gl + G * j;
    if (oi < P.n_obst) {
      const uint32_t slot = 17u + 3u * static_cast<uint32_t>(P.n_gates) + 2u * static_cast<uint32_t>(oi);
      m.ox[j] = param_at<MAX_OBSTACLES, 2, POSE_OBST>(P.pose_a, oi) +
                slot_uniform(base, slot) * param_at<MAX_OBSTACLES, 2, POSE_OBST>(P.pose_b, oi);
      m.oy[j] = param_at<MAX_OBSTACLES, 2, POSE_OBST + 1>(P.pose_a, oi) +
                slot_uniform(base, slot + 1u) * param_at<MAX_OBSTACLES, 2, POSE_OBST + 1>(P.pose_b, oi);
    }
  }
}

// The four motors' forces under action white noise (fast_env.py:341-348):
// thrust i plus std * sqrt(-2 log(1 - u_i)) * cos(2 pi u_{4+i}) on the 8
// Philox draws of call site 1 (blocks 0 and 1) at (env, step), then the
// actuation; lane i of a round takes motor i, every lane gets all four.
template <int G>
__device__ __forceinline__ void noisy_forces(const RolloutParams& P, const float* thr, int it,
                                             uint32_t seed, float* f, const LaneGroup& g) {
  const Philox4 u0 = philox4x32_10(g.e, it, 0, SITE_ACTION, seed, 0);
  const Philox4 u1 = philox4x32_10(g.e, it, 1, SITE_ACTION, seed, 0);
#pragma unroll
  for (int r0 = 0; r0 < 4; r0 += G) {
    const int i = r0 + g.gl < 4 ? r0 + g.gl : r0;
    const uint32_t w0 = i == 0 ? u0.w[0] : i == 1 ? u0.w[1] : i == 2 ? u0.w[2] : u0.w[3];
    const uint32_t w1 = i == 0 ? u1.w[0] : i == 1 ? u1.w[1] : i == 2 ? u1.w[2] : u1.w[3];
    const float t = i == 0 ? thr[0] : i == 1 ? thr[1] : i == 2 ? thr[2] : thr[3];
    const float rad = sqrtf(-2.0f * logf(1.0f - bits_to_unit(w0)));
    const float fi = actuate(t + P.act_noise_std * rad * cosf(TWO_PI * bits_to_unit(w1)));
#pragma unroll
    for (int k = 0; k < G && r0 + k < 4; ++k) f[r0 + k] = from<G>(fi, g, k);
  }
}

// The uniform dynamics force (fast_env.py:367-370): low + u_k * (high -
// low) on the 3 Philox draws of call site 3 (block 0) at (env, step).
__device__ __forceinline__ void uniform_force(const RolloutParams& P, int e, int it, uint32_t seed,
                                              float* ext) {
  const Philox4 u = philox4x32_10(e, it, 0, SITE_DYNAMICS, seed, 0);
#pragma unroll
  for (int k = 0; k < 3; ++k) ext[k] = P.dyn_lo[k] + bits_to_unit(u.w[k]) * P.dyn_span[k];
}

// One control step of K2's maze instance over the group (step_env_core,
// fast_env.py:297-590): the action white noise (or the call's constant
// forces), the impulse or uniform dynamics force, the substeps, the maze's
// geometry, quad3d.cuh::env_step with the maze's reward, done and counters,
// and after an auto-reset the poses' redraw.  thr: the preprocessed thrust
// (pre noise); it, seed: the step's Philox counter and key.
template <int G>
__device__ __forceinline__ void env_step_maze(const RolloutParams& P, EnvRows& r, const ActionTerms& a,
                                              const float* thr, int it, uint32_t seed, StepOut& o,
                                              MazeRows<G>& m, const LaneGroup& g) {
  float f[4];
  if (P.act_noise) {
    noisy_forces<G>(P, thr, it, seed, f, g);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = a.f[i];
  }
  float ext[3];
  if (P.dyn_uniform) {
    uniform_force(P, g.e, it, seed, ext);
  } else {
    ext[0] = ext[1] = ext[2] = impulse_force(P, r);
  }
  step_substeps_group<G>(P, r, f, ext, g);
  if (P.maze) maze_geometry_group<G>(P, r, m, g);
  env_step<true>(P, r, a, o, m.mc);
  if (P.maze && o.done) redraw_maze<G>(P, r, m, g);
}

}  // namespace scg
