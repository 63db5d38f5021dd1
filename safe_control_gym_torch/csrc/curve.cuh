// The closed-form planar reference curves (figure8, circle, square) of the
// CartPole and planar-quadrotor kernels (K5-K8): the JAX package's
// eval_curve (safe_control_gym_tpu/parallel/fast_env.py:232-267), evaluated
// per step instead of gathered from a table.  Plain version:
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

// The two curve components and their velocities at time t.
__device__ __forceinline__ void eval_curve(const CurveParams& P, float t, float& a_p, float& b_p,
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

// Position and velocity on the world axis that curve component `sel` (0 or
// 1) lands on, offset by the plane offset of that component; zeros for any
// other sel (fast_cartpole.py:167-174, fast_quad_planar.py:128-133).
__device__ __forceinline__ void axis_goal(const CurveParams& C, const float* plane_off, float ctrl_dt,
                                          float step_f, int sel, float& pos, float& vel) {
  if (sel != 0 && sel != 1) {
    pos = 0.0f;
    vel = 0.0f;
    return;
  }
  float a_p, b_p, a_v, b_v;
  eval_curve(C, step_f * ctrl_dt, a_p, b_p, a_v, b_v);
  pos = sel == 0 ? a_p + plane_off[0] : b_p + plane_off[1];
  vel = sel == 0 ? a_v : b_v;
}

}  // namespace scg
