// Shared device functions of the 3D-quadrotor kernels (K1 quad3d_substeps,
// K2 quad3d_rollout): the rigid-body derivative, the thrust -> force
// actuation pipeline, and the counter-based reset hash.
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

// Per-motor thrust command -> realized force: cmd2pwm -> clip -> pwm2rpm ->
// rpm^2 * KF (pallas_quad.py:98-106).
__device__ __forceinline__ float actuate(float t) {
  float pwm = (sqrtf(maxp(t, 0.0f) / KF) - PWM2RPM_CONST) / PWM2RPM_SCALE;
  pwm = clipf(pwm, MIN_PWM, MAX_PWM);
  float rpm = PWM2RPM_SCALE * pwm + PWM2RPM_CONST;
  return rpm * rpm * KF;
}

// Rigid-body physics constants and per-env parameters of one control step.
struct Body {
  float f[4];    // per-motor forces
  float ext[3];  // world-frame external force
  float minv;    // 1 / mass
  float j[3];    // inertia diagonal
  float g, l_sq2, km_over_kf;
};

// x' = fc(x): the closed form of pallas_quad.py:49-91 (SDFormat Euler
// angles, body rates, world-frame velocity).
__device__ __forceinline__ void fc(const float* s, const Body& b, float* d) {
  const float vx = s[1], vy = s[3], vz = s[5];
  const float phi = s[6], theta = s[7], psi = s[8];
  const float p = s[9], q = s[10], r = s[11];
  const float f1 = b.f[0], f2 = b.f[1], f3 = b.f[2], f4 = b.f[3];

  const float T = f1 + f2 + f3 + f4;
  const float cphi = cosf(phi), sphi = sinf(phi);
  const float cth = cosf(theta), sth = sinf(theta);
  const float cpsi = cosf(psi), spsi = sinf(psi);
  // Thrust direction = body z-axis in the world frame.
  const float zb_x = cpsi * sth * cphi + spsi * sphi;
  const float zb_y = spsi * sth * cphi - cpsi * sphi;
  const float zb_z = cth * cphi;
  const float ax = (zb_x * T + b.ext[0]) * b.minv;
  const float ay = (zb_y * T + b.ext[1]) * b.minv;
  const float az = (zb_z * T + b.ext[2]) * b.minv - b.g;

  const float mx = b.l_sq2 * (f1 + f2 - f3 - f4);
  const float my = b.l_sq2 * (-f1 + f2 + f3 - f4);
  const float mz = b.km_over_kf * (f1 - f2 + f3 - f4);
  const float jx = b.j[0], jy = b.j[1], jz = b.j[2];
  // Gyroscopic term pqr x (J pqr).
  const float gx = q * (jz * r) - r * (jy * q);
  const float gy = r * (jx * p) - p * (jz * r);
  const float gz = p * (jy * q) - q * (jx * p);

  const float tth = sth / cth;
  d[0] = vx;
  d[1] = ax;
  d[2] = vy;
  d[3] = ay;
  d[4] = vz;
  d[5] = az;
  d[6] = p + sphi * tth * q + cphi * tth * r;
  d[7] = cphi * q - sphi * r;
  d[8] = sphi / cth * q + cphi / cth * r;
  d[9] = (mx - gx) / jx;
  d[10] = (my - gy) / jy;
  d[11] = (mz - gz) / jz;
}

// One control step's n_sub substeps, RK4 or explicit Euler, in place
// (pallas_quad.py:126-137).
__device__ __forceinline__ void substeps(float* s, const Body& b, int n_sub, int euler,
                                         float dt, float dt_half, float dt_sixth) {
  float k1[NX], k2[NX], k3[NX], k4[NX], t[NX];
  for (int n = 0; n < n_sub; ++n) {
    if (euler) {
      fc(s, b, k1);
#pragma unroll
      for (int i = 0; i < NX; ++i) s[i] = s[i] + dt * k1[i];
    } else {
      fc(s, b, k1);
#pragma unroll
      for (int i = 0; i < NX; ++i) t[i] = s[i] + dt_half * k1[i];
      fc(t, b, k2);
#pragma unroll
      for (int i = 0; i < NX; ++i) t[i] = s[i] + dt_half * k2[i];
      fc(t, b, k3);
#pragma unroll
      for (int i = 0; i < NX; ++i) t[i] = s[i] + dt * k3[i];
      fc(t, b, k4);
#pragma unroll
      for (int i = 0; i < NX; ++i)
        s[i] = s[i] + dt_sixth * (k1[i] + 2.0f * k2[i] + 2.0f * k3[i] + k4[i]);
    }
  }
}

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

}  // namespace scg
