// The observation instances of the policy kernels (K3 quad3d_policy_rollout,
// K6 cartpole_policy_rollout, K8 quad_planar_policy_rollout): an
// observation that is more than the NX state rows.  It adds the TPU
// kernels' observation white noise (safe_control_gym_tpu/parallel/
// fast_env.py::obs_noise_rows, called at fast_policy.py:132 and :192,
// fast_cartpole.py:320, fast_quad_planar.py:714) and goal-horizon rows
// (fast_policy.py::_policy_rollout_kernel.goal_ext_rows :108-122,
// fast_quad_planar.py::goal_ext_rows :143-158).  Plain versions:
// safe_control_gym_torch/parallel/fast_env.py::obs_noise_rows and
// ::goal_ext_rows, fast_policy.py::terminal_obs and ::policy_rollout_loop.
//
// The observation: the state rows, each with std * sqrt(-2 log(1 - u_r)) *
// cos(2 pi u_a) added where the config has the noise (Philox call site 2,
// rows 2 b and 2 b + 1 on the four words of draw block b), then
// goal_blocks blocks of NX goal rows: the static goal once (stabilization),
// or the goal at min(step + 1 + i, goal_last) for the next i (tracking),
// clipped at the env's goal table's last row (quadrotor.py:539), not at
// the TPU kernels' max_steps - 1.  The env state and the goal rows stay
// clean.  The terminal observation (the record's, masked to truncated
// steps) takes fresh draws from block OBS_TERM_BLOCK on and the goal at
// offset 2; its noise and goal rows are drawn on truncated steps only (the
// TPU kernel draws every step and masks).
//
// Design: the observation's width D (up to MLP_MAX_OBS = 128) is read at
// run time, so the observation lives in shared memory, in front of the
// group's row of hidden layers (obs_group_row): lane gl draws the noise of
// the row pairs b = gl, gl + G, ... (one Philox block, two Box-Muller
// pairs) and evaluates the goal blocks i = gl, gl + G, ..., each writing
// its own entries, then the first layer reads the row (mlp_group_layer1_smem)
// and stores of the record are spread over the lanes.
#pragma once

#include <cstdint>

#include "lane_group.cuh"
#include "philox.cuh"
#include "policy_mlp.cuh"

namespace scg {

constexpr int MLP_MAX_OBS = 128;  // K4's and the port's kernel_scope limit (fast_update.MAX_OBS)

// The observation instance's run-time observation.  Mirrored by
// safe_control_gym_torch/parallel/fast_policy.py::ObsExtParams.
struct ObsExt {
  int obs_dim;      // D = NX * (1 + goal_blocks)
  int goal_blocks;  // goal blocks after the state rows
  float noise_std;  // observation white noise (0: none)
  float goal_last;  // last index of the env's goal table
};

// Floats of the observation row (in front of the hidden layers), a multiple
// of 32 so that the group rows keep their bank stride.
__host__ __device__ constexpr int obs_row(int d) { return (d + 31) / 32 * 32; }
__host__ __device__ constexpr int obs_group_row(int h, int d) { return obs_row(d) + mlp_group_row(h); }

// The noise of state rows 2 b and 2 b + 1: Box-Muller on words 0, 1 and
// 2, 3 of Philox block `block` at call site 2.
__device__ __forceinline__ void obs_noise_pair(float std, int e, int it, uint32_t block,
                                               uint32_t seed, float& n0, float& n1) {
  const Philox4 u = philox4x32_10(e, it, block, SITE_OBS, seed, 0);
  n0 = (std * sqrtf(-2.0f * logf(1.0f - bits_to_unit(u.w[0])))) * cosf(TWO_PI * bits_to_unit(u.w[1]));
  n1 = (std * sqrtf(-2.0f * logf(1.0f - bits_to_unit(u.w[2])))) * cosf(TWO_PI * bits_to_unit(u.w[3]));
}

// The policy's observation of state s at control step step_f into
// obs[0, D): the noisy state rows, then the goal blocks; goal(idx, out)
// writes the NX goal rows at index idx.  Every lane writes its share; the
// caller syncs the warp before reading.
template <int NX, int G, typename GoalFn>
__device__ __forceinline__ void build_obs_row(const ObsExt& X, const float (&s)[NX], float step_f,
                                              int e, int it, uint32_t seed, const LaneGroup& g,
                                              float* obs, GoalFn goal) {
  static_assert(NX % 2 == 0, "the noise takes the state rows in pairs");
  if (X.noise_std > 0.0f) {
    for (int b = g.gl; b < NX / 2; b += G) {
      float n0, n1;
      obs_noise_pair(X.noise_std, e, it, b, seed, n0, n1);
      obs[2 * b] = pick(s, 2 * b) + n0;
      obs[2 * b + 1] = pick(s, 2 * b + 1) + n1;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NX; ++k)
      if (k % G == g.gl) obs[k] = s[k];
  }
  for (int i = g.gl; i < X.goal_blocks; i += G) {
    float gr[NX];
    goal(fminf(step_f + static_cast<float>(1 + i), X.goal_last), gr);
#pragma unroll
    for (int k = 0; k < NX; ++k) obs[NX * (1 + i) + k] = gr[k];
  }
}

// The record's terminal observation, rows rec[k * B] for k < D, of the
// post-step state s of a step that began at control step step_f: on a
// truncated step the state with fresh noise (blocks OBS_TERM_BLOCK..) and
// the goal blocks at offset 2; else s * 0 on the state rows (as the JAX
// kernel's mask) and 0 on the goal rows.  Lane gl stores its share where
// `store` (a real env).
template <int NX, int G, typename GoalFn>
__device__ __forceinline__ void store_terminal_obs(const ObsExt& X, const float (&s)[NX], bool trunc,
                                                   float step_f, int e, int it, uint32_t seed,
                                                   const LaneGroup& g, bool store, float* rec, int B,
                                                   GoalFn goal) {
  if (!trunc) {
#pragma unroll
    for (int k = 0; k < NX; ++k)
      if (store && k % G == g.gl) rec[k * B] = s[k] * 0.0f;
    for (int k = NX + g.gl; k < X.obs_dim; k += G)
      if (store) rec[k * B] = 0.0f;
    return;
  }
  if (X.noise_std > 0.0f) {
    for (int b = g.gl; b < NX / 2; b += G) {
      float n0, n1;
      obs_noise_pair(X.noise_std, e, it, OBS_TERM_BLOCK + b, seed, n0, n1);
      if (store) {
        rec[2 * b * B] = pick(s, 2 * b) + n0;
        rec[(2 * b + 1) * B] = pick(s, 2 * b + 1) + n1;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < NX; ++k)
      if (store && k % G == g.gl) rec[k * B] = s[k];
  }
  for (int i = g.gl; i < X.goal_blocks; i += G) {
    float gr[NX];
    goal(fminf(step_f + static_cast<float>(2 + i), X.goal_last), gr);
#pragma unroll
    for (int k = 0; k < NX; ++k)
      if (store) rec[(NX * (1 + i) + k) * B] = gr[k];
  }
}

// Layer 1 of the dual MLP over the group on the observation row obs[0, d)
// in shared memory (mlp_group_layer1's sums, w1 . obs in input order):
// lane gl computes units gl, gl + G, ... of both nets into h1.
template <int G>
__device__ __forceinline__ void mlp_group_layer1_smem(const float* __restrict__ w, const MlpDimsD& L,
                                                      int d, const float* obs, int relu, float* h1,
                                                      const LaneGroup& g) {
  for (int u = g.gl; u < 2 * L.H; u += G) {
    const float* wr = w + L.W1 + u * L.OBS_PAD;
    float z = 0.0f;
    for (int c = 0; c < d; c += 4) {
      const float4 v = ld4(wr + c);
      z = c == 0 ? v.x * obs[0] : z + v.x * obs[c];
      if (c + 1 < d) z = z + v.y * obs[c + 1];
      if (c + 2 < d) z = z + v.z * obs[c + 2];
      if (c + 3 < d) z = z + v.w * obs[c + 3];
    }
    h1[u] = act_fn(z + __ldg(w + L.B1 + u), relu);
  }
}

// The policy step of an observation instance: the observation row of state
// s at step_f (build_obs_row) into the group's row sh, its rows stored to
// rec[k * B] (k < D, lane gl its share where `store`), the dual MLP on it
// at the width h (layer 1 from the row, then mlp_group_layers23) and the
// Gaussian sample: the NU actions, their log-prob and the value.
template <int NX, int NU, int G, typename GoalFn>
__device__ __forceinline__ void obs_policy_step(const ObsExt& X, const float* __restrict__ w, int h,
                                                int relu, const float (&s)[NX], float step_f,
                                                int it, uint32_t seed, float* sh,
                                                const LaneGroup& g, bool store, float* rec, int B,
                                                GoalFn goal, float* act, float& value, float& logp) {
  const int D = X.obs_dim;
  build_obs_row<NX, G>(X, s, step_f, g.e, it, seed, g, sh, goal);
  __syncwarp();
  for (int k = g.gl; k < D; k += G)
    if (store) rec[k * B] = sh[k];
  const MlpDimsD L(h, D);
  float* mlp = sh + obs_row(D);
  float mean[NU];
  mlp_group_layer1_smem<G>(w, L, D, sh, relu, mlp, g);
  mlp_group_layers23<NU, 0, G>(w, L, relu, mlp, g, mean, value);
  gaussian_sample_at<NU>(w, L.B3, L.LOGSTD, mean, g.e, it, seed, act, logp);
}

}  // namespace scg
