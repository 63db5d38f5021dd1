// One env over a group of G lanes of a warp: the lane group every grouped
// kernel takes its place from (lane_group, from), its rounds of divisions
// and sines (div_round, sincos_round), the 3D quadrotor's grouped
// derivative and substeps (fc_group, substeps_group: K1 quad3d_substeps in
// float and double, and the control step of K2 quad3d_rollout and K3
// quad3d_policy_rollout, env_step_group; their maze instances add
// maze.cuh), and the policy kernels' grouped dual MLP (K3, K6
// cartpole_policy_rollout, K8 quad_planar_policy_rollout).
//
// Why: with one thread per env, B = 4096 envs are 128 warps for the card's
// 528 warp schedulers, and each thread's step is one dependent chain.  In
// that chain each accurate sinf/cosf and each IEEE division is a region of
// its own (a convergence barrier around its rare slow path), so the six
// trigonometric calls and six divisions of every rigid-body derivative run
// one after another.  A group runs them side by side, one angle's sincos
// and one division per lane, and hands the results round with __shfl_sync;
// the MLP's sums split over the lanes.  G lanes per env also make G times
// as many warps.  A group of fewer lanes than a round's values takes the
// round in turns (G = 1 is one thread per env, one sincos per angle).
//
// What does not change: every value is computed by the same operations in
// the same order as in the one-thread forms (the derivative as
// pallas_quad.py writes it, policy_mlp.cuh::mlp_net / mlp_net_wide), only
// on another lane, so the results are bit-equal to them and to the plain
// versions.  Every lane of a group holds the env's rows and runs
// the rest of the step on identical registers.  No lane returns early: a
// lane past the last env runs env B - 1 (LaneGroup::e) and stores nothing,
// so every lane of a warp joins every exchange (full-warp masks).
#pragma once

#include <cstdint>

#include "policy_mlp.cuh"
#include "quad3d.cuh"

namespace scg {

constexpr unsigned FULL_MASK = 0xffffffffu;

// A thread's place: env e (clamped to B - 1), its lane gl in the group, the
// warp lane of the group's lane 0, and whether e is a real env.  Blocks are
// whole warps and G divides 32, so a group never straddles two warps; G = 1
// is one thread per env.
struct LaneGroup {
  int e, gl, base;
  bool valid;
};

template <int G>
__device__ __forceinline__ LaneGroup lane_group(int B) {
  static_assert(G >= 1 && 32 % G == 0, "a group holds 1, 2, 4, 8, 16 or 32 lanes of one warp");
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  LaneGroup g;
  g.gl = static_cast<int>(threadIdx.x) % G;
  g.base = static_cast<int>(threadIdx.x & 31u) - g.gl;
  g.valid = t / G < B;
  g.e = g.valid ? t / G : B - 1;
  return g;
}

// v[min(i, N - 1)] without indexing registers by a run-time value.
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int i) {
  float r = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k) r = i >= k ? v[k] : r;
  return r;
}

// Lane i's value of v (a plain read in a group of one), float or double.
template <int G, typename T>
__device__ __forceinline__ T from(T v, const LaneGroup& g, int i) {
  if constexpr (G == 1) {
    return v;
  } else {
    return __shfl_sync(FULL_MASK, v, g.base + i);
  }
}

// q[k] = num[k] / den[k] for k < N, lane i of a round taking the i-th
// division of the round, in rounds of G lanes; every lane gets all N.
template <int G, int N, typename T>
__device__ __forceinline__ void div_round(const T (&num)[N], const T (&den)[N], T (&q)[N],
                                          const LaneGroup& g) {
#pragma unroll
  for (int r0 = 0; r0 < N; r0 += G) {
    T n = num[r0], d = den[r0];
#pragma unroll
    for (int i = 1; i < G && r0 + i < N; ++i) {
      n = g.gl >= i ? num[r0 + i] : n;
      d = g.gl >= i ? den[r0 + i] : d;
    }
    const T qt = n / d;
#pragma unroll
    for (int i = 0; i < G && r0 + i < N; ++i) q[r0 + i] = from<G>(qt, g, i);
  }
}

// sn[k], cs[k] = sin, cos of a[k] for k < N, one sincos a lane per round.
template <int G, int N, typename T>
__device__ __forceinline__ void sincos_round(const T (&a)[N], T (&sn)[N], T (&cs)[N],
                                             const LaneGroup& g) {
#pragma unroll
  for (int r0 = 0; r0 < N; r0 += G) {
    T x = a[r0];
#pragma unroll
    for (int i = 1; i < G && r0 + i < N; ++i) x = g.gl >= i ? a[r0 + i] : x;
    T s, c;
    sincos_t(x, &s, &c);
#pragma unroll
    for (int i = 0; i < G && r0 + i < N; ++i) {
      sn[r0 + i] = from<G>(s, g, i);
      cs[r0 + i] = from<G>(c, g, i);
    }
  }
}

// x' = fc(x), the closed form of pallas_quad.py:49-91 (SDFormat Euler
// angles, body rates, world-frame velocity), over the group: lane i takes
// the sine and cosine of angle i (phi, theta, psi) in one sincos, and the
// i-th division (sth/cth, sphi/cth, cphi/cth, then the three body-rate
// rows), in rounds of G lanes; every lane gets all twelve rows.
template <int G, typename T>
__device__ __forceinline__ void fc_group(const T* s, const BodyT<T>& b, T* d, const LaneGroup& g) {
  const T vx = s[1], vy = s[3], vz = s[5];
  const T p = s[9], q = s[10], r = s[11];
  const T f1 = b.f[0], f2 = b.f[1], f3 = b.f[2], f4 = b.f[3];

  const T tsum = f1 + f2 + f3 + f4;
  const T ang[3] = {s[6], s[7], s[8]};
  T sn[3], cs[3];
  sincos_round<G, 3>(ang, sn, cs, g);
  const T cphi = cs[0], sphi = sn[0];
  const T cth = cs[1], sth = sn[1];
  const T cpsi = cs[2], spsi = sn[2];
  // Thrust direction = body z-axis in the world frame.
  const T zb_x = cpsi * sth * cphi + spsi * sphi;
  const T zb_y = spsi * sth * cphi - cpsi * sphi;
  const T zb_z = cth * cphi;
  const T ax = (zb_x * tsum + b.ext[0]) * b.minv;
  const T ay = (zb_y * tsum + b.ext[1]) * b.minv;
  const T az = (zb_z * tsum + b.ext[2]) * b.minv - b.g;

  const T mx = b.l_sq2 * (f1 + f2 - f3 - f4);
  const T my = b.l_sq2 * (-f1 + f2 + f3 - f4);
  const T mz = b.km_over_kf * (f1 - f2 + f3 - f4);
  const T jx = b.j[0], jy = b.j[1], jz = b.j[2];
  // Gyroscopic term pqr x (J pqr).
  const T gx = q * (jz * r) - r * (jy * q);
  const T gy = r * (jx * p) - p * (jz * r);
  const T gz = p * (jy * q) - q * (jx * p);

  const T num[6] = {sth, sphi, cphi, mx - gx, my - gy, mz - gz};
  const T den[6] = {cth, cth, cth, jx, jy, jz};
  T quo[6];
  div_round<G, 6>(num, den, quo, g);
  const T tth = quo[0];
  d[0] = vx;
  d[1] = ax;
  d[2] = vy;
  d[3] = ay;
  d[4] = vz;
  d[5] = az;
  d[6] = p + sphi * tth * q + cphi * tth * r;
  d[7] = cphi * q - sphi * r;
  d[8] = quo[1] * q + quo[2] * r;
  d[9] = quo[3];
  d[10] = quo[4];
  d[11] = quo[5];
}

// One control step's n_sub substeps, RK4 or explicit Euler, in place
// (pallas_quad.py:126-137), with the group's derivative.
template <int G, typename T>
__device__ __forceinline__ void substeps_group(T* s, const BodyT<T>& b, int n_sub, int euler, T dt,
                                               T dt_half, T dt_sixth, const LaneGroup& g) {
  T k1[NX], k2[NX], k3[NX], k4[NX], t[NX];
  for (int n = 0; n < n_sub; ++n) {
    if (euler) {
      fc_group<G>(s, b, k1, g);
#pragma unroll
      for (int i = 0; i < NX; ++i) s[i] = s[i] + dt * k1[i];
    } else {
      fc_group<G>(s, b, k1, g);
#pragma unroll
      for (int i = 0; i < NX; ++i) t[i] = s[i] + dt_half * k1[i];
      fc_group<G>(t, b, k2, g);
#pragma unroll
      for (int i = 0; i < NX; ++i) t[i] = s[i] + dt_half * k2[i];
      fc_group<G>(t, b, k3, g);
#pragma unroll
      for (int i = 0; i < NX; ++i) t[i] = s[i] + dt * k3[i];
      fc_group<G>(t, b, k4, g);
#pragma unroll
      for (int i = 0; i < NX; ++i)
        s[i] = s[i] + dt_sixth * (k1[i] + T(2) * k2[i] + T(2) * k3[i] + k4[i]);
    }
  }
}

// The impulse schedule's force at the step (fast_env.py:356-366), 0 where
// the config has none.
__device__ __forceinline__ float impulse_force(const RolloutParams& P, const EnvRows& r) {
  float n = 0.0f;
  if (P.impulse) {
    const float peak = r.offset + P.imp_peak_shift;
    const float po = fabsf(r.step_f - peak);
    const float dec = po < P.imp_half_dur ? (P.decay_one ? 1.0f : expf(po * P.imp_log_decay)) : 0.0f;
    n = r.step_f >= r.offset ? P.imp_mag * dec : 0.0f;
  }
  return n;
}

// One control step's substeps over the group, in place on r.s, with the
// motors' forces f and the world-frame force ext.
template <int G>
__device__ __forceinline__ void step_substeps_group(const RolloutParams& P, EnvRows& r, const float* f,
                                                    const float* ext, const LaneGroup& g) {
  Body b;
#pragma unroll
  for (int i = 0; i < 4; ++i) b.f[i] = f[i];
  b.g = P.g;
  b.l_sq2 = P.l_sq2;
  b.km_over_kf = P.km_over_kf;
  b.ext[0] = ext[0];
  b.ext[1] = ext[1];
  b.ext[2] = ext[2];
  b.minv = 1.0f / r.mass;
  b.j[0] = r.jd[0];
  b.j[1] = r.jd[1];
  b.j[2] = r.jd[2];
  substeps_group<G, float>(r.s, b, P.n_sub, P.euler, P.dt, P.dt_half, P.dt_sixth, g);
}

// One control step without the maze and the step noise (K2's and K3's
// instances for such configs) over the group: the impulse schedule and the
// substeps, then quad3d.cuh::env_step, the rest of the step (goal,
// violation, reward, done, statistics, auto-reset) on the state they left.
// The maze instances of K2 and K3 run maze.cuh::env_step_maze instead.
template <int G>
__device__ __forceinline__ void env_step_group(const RolloutParams& P, EnvRows& r,
                                               const ActionTerms& a, StepOut& o, const LaneGroup& g) {
  const float n = impulse_force(P, r);
  const float ext[3] = {n, n, n};
  step_substeps_group<G>(P, r, a.f, ext, g);
  MazeCounters none;
  env_step(P, r, a, o, none);
}

// Shared-memory floats of one group's row for a dual MLP of width h: the
// first and second hidden layers of both nets (4h), at a stride that puts
// the rows of a warp's groups in different banks (a multiple of 32, plus 4).
__host__ __device__ constexpr int mlp_group_row(int h) { return 4 * ((h + 7) / 8 * 8) + 4; }

// Layer 1 of the dual MLP over the group (dual_mlp_group): lane gl computes
// units gl, gl + G, ... of both nets from the OBS observation rows obs (in
// registers) into h1, the group's row of shared memory.
template <int OBS, int G, typename Dims>
__device__ __forceinline__ void mlp_group_layer1(const float* __restrict__ w, const Dims& L,
                                                 const float* obs, int relu, float* h1,
                                                 const LaneGroup& g) {
  constexpr int OBS_PAD = MlpDims<OBS>::OBS_PAD;
  for (int u = g.gl; u < 2 * L.H; u += G) {
    float wr[OBS_PAD];
#pragma unroll
    for (int c = 0; c < OBS_PAD; c += 4) {
      const float4 v = ld4(w + L.W1 + u * OBS_PAD + c);
      wr[c] = v.x;
      wr[c + 1] = v.y;
      wr[c + 2] = v.z;
      wr[c + 3] = v.w;
    }
    float z = wr[0] * obs[0];
#pragma unroll
    for (int c = 1; c < OBS; ++c) z = z + wr[c] * obs[c];
    h1[u] = act_fn(z + __ldg(w + L.B1 + u), relu);
  }
}

// Layers 2 and 3 of the dual MLP over the group (dual_mlp_group), on the
// first hidden layer h1 = sh[0, 2h) that every lane of the group wrote, at
// the fixed width H or (H = 0) the width L.H.  Layer 2: lane gl owns the
// float4 column chunks 4 gl + 4 G m of each net and sums each of their units
// over k = 0..h-1 in order, into h2 = sh[2h, 4h).  Output layer: lane gl
// sums outputs gl, gl + G, ... (0..NU-1 the means, NU the value) over j =
// 0..h-1 in order.  Every lane gets the means and the value.
template <int NU, int H, int G, typename Dims>
__device__ __forceinline__ void mlp_group_layers23(const float* __restrict__ w, const Dims& L,
                                                   int relu, float* sh, const LaneGroup& g,
                                                   float* mean, float& value) {
  constexpr int HC = H > 0 ? (H + MLP_CHUNK - 1) / MLP_CHUNK * MLP_CHUNK : MLP_MAX_H;
  constexpr int NCH = (HC + 4 * G - 1) / (4 * G);  // column chunks a lane owns in a net
  constexpr int NO = (NU + G) / G;                 // outputs a lane sums
  const int hh = L.H;
  const float* h1 = sh;
  float* h2 = sh + 2 * hh;
  __syncwarp();

  // A chunk past the net's width reads chunk 0 instead: no branch in the
  // k-loop, and its sums are dropped.
  int col[NCH];
#pragma unroll
  for (int m = 0; m < NCH; ++m) col[m] = 4 * g.gl + 4 * G * m < hh ? 4 * g.gl + 4 * G * m : 0;
#pragma unroll
  for (int net = 0; net < 2; ++net) {
    const int base = net * hh;
    const float* w2 = w + L.W2T + net * L.HP + base * 2 * L.HP;
    float acc[4 * NCH];
    {
      const float x = h1[base];
#pragma unroll
      for (int m = 0; m < NCH; ++m) {
        const float4 v = ld4(w2 + col[m]);
        acc[4 * m] = v.x * x;
        acc[4 * m + 1] = v.y * x;
        acc[4 * m + 2] = v.z * x;
        acc[4 * m + 3] = v.w * x;
      }
    }
#pragma unroll 4
    for (int k = 1; k < hh; ++k) {
      const float x = h1[base + k];
      const float* row = w2 + k * 2 * L.HP;
#pragma unroll
      for (int m = 0; m < NCH; ++m) {
        const float4 v = ld4(row + col[m]);
        acc[4 * m] = acc[4 * m] + v.x * x;
        acc[4 * m + 1] = acc[4 * m + 1] + v.y * x;
        acc[4 * m + 2] = acc[4 * m + 2] + v.z * x;
        acc[4 * m + 3] = acc[4 * m + 3] + v.w * x;
      }
    }
#pragma unroll
    for (int m = 0; m < NCH; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * g.gl + 4 * G * m + i;
        if (j < hh) h2[base + j] = act_fn(acc[4 * m + i] + __ldg(w + L.B2 + base + j), relu);
      }
    }
  }
  __syncwarp();

  float out[NO];
#pragma unroll
  for (int m = 0; m < NO; ++m) {
    const int o = g.gl + G * m;
    out[m] = 0.0f;
    if (o <= NU) {
      const int base = o < NU ? 0 : hh;
      const float* w3 = w + L.W3T + base * 8 + o;
      float sum = __ldg(w3) * h2[base];
#pragma unroll 4
      for (int j = 1; j < hh; ++j) sum = sum + __ldg(w3 + j * 8) * h2[base + j];
      out[m] = o < NU ? sum : sum + __ldg(w + L.B3 + NU);  // the means' bias joins in the sample
    }
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) mean[i] = from<G>(out[i / G], g, i % G);
  value = from<G>(out[NU / G], g, NU % G);
}

// policy_mlp.cuh::dual_mlp over the group, at the fixed width H or (H = 0)
// the width h, on the OBS observation rows obs in registers; sh is the
// group's row of shared memory (mlp_group_row floats): layer 1
// (mlp_group_layer1), then layers 2 and 3 (mlp_group_layers23).
template <int OBS, int NU, int H, int G>
__device__ __forceinline__ void dual_mlp_group(const float* __restrict__ w, int h, const float* obs,
                                               int relu, float* sh, const LaneGroup& g, float* mean,
                                               float& value) {
  const MlpDims<OBS> L(H > 0 ? H : h);
  mlp_group_layer1<OBS, G>(w, L, obs, relu, sh, g);
  mlp_group_layers23<NU, H, G>(w, L, relu, sh, g, mean, value);
}

}  // namespace scg
