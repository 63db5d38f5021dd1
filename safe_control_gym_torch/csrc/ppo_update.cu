// K4: exact PPO actor+critic gradients of one minibatch.
//
// Replaces safe_control_gym_tpu/parallel/fast_update.py::_make_kernel_body
// -> body (:44-207): the dual-MLP forward, the clipped-surrogate and
// value-MSE losses, and the hand-written backward (the jnp.minimum /
// jnp.clip subgradient conventions of :151-158), giving the 12 weight and
// bias gradients, the logstd gradient and 3 loss sums.  Plain version:
// safe_control_gym_torch/parallel/fast_update.py::ppo_grads_plain.
//
// Layout: the packed minibatch (F = nx+nu+4, mb), batch last, rows at the
// JAX offsets (obs 0..nx-1, act nx..nx+nu-1, v, logp_old, ret, adv); v is
// unused (use_clipped_value=False).  Weights and gradients are one flat
// float vector each, in segment order
//   w1a (H,nx) b1a (H) w2a (H,H) b2a (H) w3a (nu,H) b3a (nu)
//   w1c (H,nx) b1c (H) w2c (H,H) b2c (H) w3c (1,H)  b3c (1)  logstd (nu)
// in kernel orientation W (out, in); the gradient vector appends the loss
// sums [sum min_surr, sum (logp_old - logp), sum (v - ret)^2].
//
// Design.  The TPU kernel walks the minibatch in 4096-sample chunks on one
// core and accumulates into its outputs across grid steps.  Here blocks run
// in no order, so the work is two launches:
//   1. ppo_grads_kernel: each block stages the weights in shared memory and
//      walks a fixed set of 32-sample tiles.  Per tile it runs the forward
//      and backward of both nets as small block-wide products into shared
//      memory (a1 a2 c1 c2, gmean gv, ga2 gc2, ga1 gc1; rows padded to 33
//      floats so that no two lanes of a warp hit one bank), then every
//      thread adds the tile's share of its own gradient entries
//      (dW = G A^T over the tile, bias = sum G) into registers.  At the end
//      each block writes its partial gradient vector.
//   2. ppo_grads_reduce_kernel: one thread per gradient entry sums the blocks'
//      partials in block order.
// No float atomics: two launches on the same input agree bit for bit.
//
// Bound on an H100: operations.  Per sample the forward of both H = 64 nets
// is ~20k flops, the backward ~17k and the gradient accumulation ~21k; at
// mb = 131072 that is ~7.6 GFLOP, ~0.11 ms at 67 TFLOP/s f32, against
// ~10.5 MB of minibatch read (3 us at 3.35 TB/s).  Every product is f32
// FMA-free (-fmad=false) on the CUDA cores; tensor cores (TF32) would not
// keep f32 exactness.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TS = 32;       // samples per tile
constexpr int LD = TS + 1;   // padded shared-memory row stride
constexpr int NT = 256;      // threads per block
constexpr int NACC = 48;     // gradient entries per thread (NG <= NT * NACC)
constexpr float HALF_LOG_2PI = 0.918938533204672741780329736406f;

struct UpdateParams {
  int nx, nu, H, mb, relu, n_tiles;
  float clip_lo, clip_hi, inv_n;
};

// Offsets of the weight (and gradient) segments in the flat vectors.
struct Seg {
  int w1a, b1a, w2a, b2a, w3a, b3a, w1c, b1c, w2c, b2c, w3c, b3c, logstd, sums, ng;
};

__host__ __device__ inline Seg segments(int nx, int nu, int H) {
  Seg s;
  int o = 0;
  s.w1a = o; o += H * nx;
  s.b1a = o; o += H;
  s.w2a = o; o += H * H;
  s.b2a = o; o += H;
  s.w3a = o; o += nu * H;
  s.b3a = o; o += nu;
  s.w1c = o; o += H * nx;
  s.b1c = o; o += H;
  s.w2c = o; o += H * H;
  s.b2c = o; o += H;
  s.w3c = o; o += H;
  s.b3c = o; o += 1;
  s.logstd = o; o += nu;
  s.sums = o; o += 3;
  s.ng = o;
  return s;
}

// Shared-memory row offsets (in floats, after the staged weights).
struct Rows {
  int in, a1, a2, out, gm, gv, gl, su, g2, g1, total;
};

__host__ __device__ inline Rows rows_layout(int nw, int nx, int nu, int H) {
  Rows r;
  int o = nw;
  const int F = nx + nu + 4;
  r.in = o; o += F * LD;
  r.a1 = o; o += 2 * H * LD;   // actor a1 rows 0..H-1, critic c1 rows H..2H-1
  r.a2 = o; o += 2 * H * LD;   // a2 | c2
  r.out = o; o += (nu + 1) * LD;  // mean rows 0..nu-1, value row nu
  r.gm = o; o += nu * LD;      // d loss / d mean
  r.gv = o; o += LD;           // d loss / d value
  r.gl = o; o += nu * LD;      // per-sample logstd-gradient terms
  r.su = o; o += 3 * LD;       // per-sample loss-sum terms
  r.g2 = o; o += 2 * H * LD;   // ga2 | gc2
  r.g1 = o; o += 2 * H * LD;   // ga1 | gc1
  r.total = o;
  return r;
}

__device__ __forceinline__ float act_fn(float z, int relu) {
  return relu ? ((z > 0.0f || z != z) ? z : 0.0f) : tanhf(z);  // jnp.maximum keeps NaN
}

// tanh' = 1 - a^2; relu' = [z > 0], and z > 0 iff relu(z) > 0.
__device__ __forceinline__ float act_grad(float a, int relu) {
  return relu ? (a > 0.0f ? 1.0f : 0.0f) : 1.0f - a * a;
}

__global__ void __launch_bounds__(NT) ppo_grads_kernel(const UpdateParams P,
                                                       const float* __restrict__ mb,
                                                       const float* __restrict__ wflat,
                                                       float* __restrict__ partial) {
  extern __shared__ float sm[];
  const int nx = P.nx, nu = P.nu, H = P.H, H2 = 2 * H, tid = threadIdx.x;
  const Seg S = segments(nx, nu, H);
  const int nw = S.sums;  // weights end where the loss sums begin
  const Rows R = rows_layout(nw, nx, nu, H);
  const int F = nx + nu + 4;
  const int r_act = nx, r_logp = nx + nu + 1, r_ret = nx + nu + 2, r_adv = nx + nu + 3;

  for (int i = tid; i < nw; i += NT) sm[i] = wflat[i];

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

  for (int tile = blockIdx.x; tile < P.n_tiles; tile += gridDim.x) {
    const int base = tile * TS;
    const int count = min(TS, P.mb - base);
    __syncthreads();  // weights staged / previous tile's rows consumed

    // -- load the tile (coalesced along samples); padding samples read 0.
    for (int o = tid; o < F * TS; o += NT) {
      const int f = o / TS, s = o % TS;
      sm[R.in + f * LD + s] = s < count ? mb[static_cast<size_t>(f) * P.mb + base + s] : 0.0f;
    }
    __syncthreads();

    // -- forward, layer 1: z = W1 x + b1 for both nets.
    for (int o = tid; o < H2 * TS; o += NT) {
      const int m = o / TS, s = o % TS;
      const int net = m >= H, mm = m - net * H;
      const float* W = sm + (net ? S.w1c : S.w1a) + mm * nx;
      float a = W[0] * sm[R.in + s];
      for (int k = 1; k < nx; ++k) a = a + W[k] * sm[R.in + k * LD + s];
      sm[R.a1 + m * LD + s] = act_fn(a + sm[(net ? S.b1c : S.b1a) + mm], P.relu);
    }
    __syncthreads();

    // -- layer 2.
    for (int o = tid; o < H2 * TS; o += NT) {
      const int m = o / TS, s = o % TS;
      const int net = m >= H, mm = m - net * H;
      const float* W = sm + (net ? S.w2c : S.w2a) + mm * H;
      const float* X = sm + R.a1 + net * H * LD + s;
      float a = W[0] * X[0];
      for (int k = 1; k < H; ++k) a = a + W[k] * X[k * LD];
      sm[R.a2 + m * LD + s] = act_fn(a + sm[(net ? S.b2c : S.b2a) + mm], P.relu);
    }
    __syncthreads();

    // -- output layer: mean rows 0..nu-1, value row nu.
    for (int o = tid; o < (nu + 1) * TS; o += NT) {
      const int m = o / TS, s = o % TS;
      const int net = m >= nu;
      const float* W = sm + (net ? S.w3c : S.w3a + m * H);
      const float* X = sm + R.a2 + net * H * LD + s;
      float a = W[0] * X[0];
      for (int k = 1; k < H; ++k) a = a + W[k] * X[k * LD];
      sm[R.out + m * LD + s] = a + sm[net ? S.b3c : S.b3a + m];
    }
    __syncthreads();

    // -- per-sample losses and the gradients at the outputs
    // (fast_update.py:142-190).
    for (int s = tid; s < TS; s += NT) {
      const float* in = sm + R.in + s;
      float logp = 0.0f;
      for (int i = 0; i < nu; ++i) {
        const float ls = sm[S.logstd + i];
        const float inv_var = expf(-2.0f * ls);
        const float diff = in[(r_act + i) * LD] - sm[R.out + i * LD + s];
        logp = logp + (-0.5f * diff * diff * inv_var - ls - HALF_LOG_2PI);
      }
      const float logp_old = in[r_logp * LD], ret = in[r_ret * LD], adv = in[r_adv * LD];
      const float ratio = expf(logp - logp_old);
      const float surr1 = ratio * adv;
      // jnp.clip: maximum then minimum, both keeping a NaN ratio.
      const float lo_c = (ratio > P.clip_lo || ratio != ratio) ? ratio : P.clip_lo;
      const float surr2 = ((lo_c < P.clip_hi || lo_c != lo_c) ? lo_c : P.clip_hi) * adv;
      const float min_surr = surr1 < surr2 ? surr1 : surr2;
      // minimum passes to the smaller branch (half each at exact ties);
      // clip passes iff the ratio is strictly inside the bounds.
      const float take1 = (surr1 < surr2 ? 1.0f : 0.0f) + 0.5f * (surr1 == surr2 ? 1.0f : 0.0f);
      const float inside = (ratio > P.clip_lo && ratio < P.clip_hi) ? 1.0f : 0.0f;
      const bool valid = s < count;
      const float w_pol = valid ? -P.inv_n * (take1 + (1.0f - take1) * inside) * ratio * adv : 0.0f;
      for (int i = 0; i < nu; ++i) {
        const float ls = sm[S.logstd + i];
        const float inv_var = expf(-2.0f * ls);
        const float diff = in[(r_act + i) * LD] - sm[R.out + i * LD + s];
        sm[R.gm + i * LD + s] = w_pol * (diff * inv_var);
        sm[R.gl + i * LD + s] = w_pol * (diff * diff * inv_var - 1.0f);
      }
      const float verr = sm[R.out + nu * LD + s] - ret;
      sm[R.gv + s] = valid ? P.inv_n * verr : 0.0f;
      sm[R.su + s] = valid ? min_surr : 0.0f;
      sm[R.su + LD + s] = valid ? logp_old - logp : 0.0f;
      sm[R.su + 2 * LD + s] = valid ? verr * verr : 0.0f;
    }
    __syncthreads();

    // -- backward into the second hidden layers: ga2 = (W3a^T gmean) f'(a2),
    // gc2 = (w3c^T gv) f'(c2).
    for (int o = tid; o < H2 * TS; o += NT) {
      const int m = o / TS, s = o % TS;
      float g;
      if (m < H) {
        g = sm[S.w3a + m] * sm[R.gm + s];
        for (int i = 1; i < nu; ++i) g = g + sm[S.w3a + i * H + m] * sm[R.gm + i * LD + s];
      } else {
        g = sm[S.w3c + m - H] * sm[R.gv + s];
      }
      sm[R.g2 + m * LD + s] = g * act_grad(sm[R.a2 + m * LD + s], P.relu);
    }
    __syncthreads();

    // -- backward into the first hidden layers: ga1 = (W2a^T ga2) f'(a1).
    for (int o = tid; o < H2 * TS; o += NT) {
      const int m = o / TS, s = o % TS;
      const int net = m >= H, mm = m - net * H;
      const float* W = sm + (net ? S.w2c : S.w2a) + mm;
      const float* G = sm + R.g2 + net * H * LD + s;
      float g = W[0] * G[0];
      for (int j = 1; j < H; ++j) g = g + W[j * H] * G[j * LD];
      sm[R.g1 + m * LD + s] = g * act_grad(sm[R.a1 + m * LD + s], P.relu);
    }
    __syncthreads();

    // -- this tile's share of every gradient entry the thread owns:
    // entry (r, c) of a weight segment adds sum_s G[r][s] * A[c][s], a
    // bias-like entry adds sum_s G[r][s].
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int e = tid + i * NT;
      if (e < S.ng) {
        int g_row, a_row = -1;
        if (e < S.b1a) { const int q = e - S.w1a; g_row = R.g1 + (q / nx) * LD; a_row = R.in + (q % nx) * LD; }
        else if (e < S.w2a) { g_row = R.g1 + (e - S.b1a) * LD; }
        else if (e < S.b2a) { const int q = e - S.w2a; g_row = R.g2 + (q / H) * LD; a_row = R.a1 + (q % H) * LD; }
        else if (e < S.w3a) { g_row = R.g2 + (e - S.b2a) * LD; }
        else if (e < S.b3a) { const int q = e - S.w3a; g_row = R.gm + (q / H) * LD; a_row = R.a2 + (q % H) * LD; }
        else if (e < S.w1c) { g_row = R.gm + (e - S.b3a) * LD; }
        else if (e < S.b1c) { const int q = e - S.w1c; g_row = R.g1 + (H + q / nx) * LD; a_row = R.in + (q % nx) * LD; }
        else if (e < S.w2c) { g_row = R.g1 + (H + e - S.b1c) * LD; }
        else if (e < S.b2c) { const int q = e - S.w2c; g_row = R.g2 + (H + q / H) * LD; a_row = R.a1 + (H + q % H) * LD; }
        else if (e < S.w3c) { g_row = R.g2 + (H + e - S.b2c) * LD; }
        else if (e < S.b3c) { g_row = R.gv; a_row = R.a2 + (H + e - S.w3c) * LD; }
        else if (e < S.logstd) { g_row = R.gv; }
        else if (e < S.sums) { g_row = R.gl + (e - S.logstd) * LD; }
        else { g_row = R.su + (e - S.sums) * LD; }
        float a = acc[i];
        if (a_row >= 0) {
          for (int s = 0; s < TS; ++s) a = a + sm[g_row + s] * sm[a_row + s];
        } else {
          for (int s = 0; s < TS; ++s) a = a + sm[g_row + s];
        }
        acc[i] = a;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int e = tid + i * NT;
    if (e < S.ng) partial[static_cast<size_t>(blockIdx.x) * S.ng + e] = acc[i];
  }
}

// out[e] = sum over blocks b = 0.. of partial[b][e], in block order.
__global__ void ppo_grads_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                        int ng, int nblk) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= ng) return;
  float a = partial[e];
  for (int b = 1; b < nblk; ++b) a = a + partial[static_cast<size_t>(b) * ng + e];
  out[e] = a;
}

}  // namespace

// Sizes the wrapper allocates for: gradient entries (flat), blocks of the
// first launch, and its dynamic shared memory in bytes.
extern "C" int ppo_grads_plan(int nx, int nu, int H, int mb, int* ng, int* nblk, int* smem_bytes) {
  const Seg S = segments(nx, nu, H);
  const Rows R = rows_layout(S.sums, nx, nu, H);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_tiles = (mb + TS - 1) / TS;
  *ng = S.ng;
  *nblk = n_tiles < 2 * sms ? n_tiles : 2 * sms;
  *smem_bytes = R.total * static_cast<int>(sizeof(float));
  if (S.ng > NT * NACC) return -1;  // more gradient entries than the block holds
  return static_cast<int>(err);
}

extern "C" int ppo_grads(int nx, int nu, int H, int mb, int relu, float clip_lo, float clip_hi,
                         float inv_n, const void* mb_ptr, const void* wflat, void* partial, void* out,
                         int nblk, int smem_bytes, void* stream) {
  UpdateParams P;
  P.nx = nx;
  P.nu = nu;
  P.H = H;
  P.mb = mb;
  P.relu = relu;
  P.n_tiles = (mb + TS - 1) / TS;
  P.clip_lo = clip_lo;
  P.clip_hi = clip_hi;
  P.inv_n = inv_n;
  const int ng = segments(nx, nu, H).ng;
  cudaError_t err = cudaFuncSetAttribute(ppo_grads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  ppo_grads_kernel<<<nblk, NT, smem_bytes, st>>>(P, static_cast<const float*>(mb_ptr),
                                                 static_cast<const float*>(wflat),
                                                 static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ppo_grads_reduce_kernel<<<(ng + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial),
                                                  static_cast<float*>(out), ng, nblk);
  return static_cast<int>(cudaGetLastError());
}
