// The closed-form planar reference curves (figure8, circle, square) of the
// CartPole and planar-quadrotor kernels (K5-K8): the JAX package's
// eval_curve (safe_control_gym_tpu/parallel/fast_env.py:232-267), evaluated
// per step instead of gathered from a table.  The figure-8 and the circle
// are lane_group_planar.cuh::axis_goal_sc's (their sine and cosine come
// from a sincosf round); the square is square_curve.  Plain version:
// safe_control_gym_torch/parallel/fast_env.py::eval_curve.  Mirrored field
// for field by parallel/fast_cartpole.py::CurveParams; every float is the
// float32 rounding of the expression the plain version evaluates.
#pragma once

namespace scg {

struct CurveParams {
  int traj_type;  // 0 figure8, 1 circle, 2 square
  float traj_w, traj_scale, traj_neg_scale, traj_sc_w, traj_neg_sc_w;
  float traj_period, traj_seg_period, traj_speed, traj_neg_speed;
};

// The square's two components and their velocities at time t: a
// piecewise-linear perimeter.
__device__ __forceinline__ void square_curve(const CurveParams& P, float t, float& a_p, float& b_p,
                                             float& a_v, float& b_v) {
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

}  // namespace scg
