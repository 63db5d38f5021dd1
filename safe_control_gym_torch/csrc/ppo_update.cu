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
// Scope: nx <= 128, nu <= 8, H <= 256, mb a positive multiple of 8
// (fast_update.kernel_scope).
//
// Bound on an H100: operations.  Per sample the forward of both H = 64 nets
// is ~20k flops, the backward ~17k and the gradient accumulation ~21k; at
// mb = 131072 that is ~7.6 GFLOP, ~0.11 ms at 67 TFLOP/s f32 (FFMA), against
// ~10.5 MB of minibatch read (3 us at 3.35 TB/s).  Tensor cores (TF32) would
// not keep f32 exactness.
//
// Design.  The actor and the critic share only the input, so every block
// works on one net (blockIdx.y even: actor, odd: critic) and walks a fixed
// set of sample tiles (TS = 64, or 32 where shared memory is short).  Per
// tile, in shared memory, rows of TS samples (stride TS + 4 floats):
//   X' = [obs; 0-pad; 1; 0 0 0]          (kx  = nxp + 4 rows)
//   A1' = [f(W1 X + b1); 1; 0 0 0]       (kh  = hp + 4 rows)
//   A2' = [f(W2 A1 + b2); 1; 0 0 0]
//   G3  = [d loss / d out (nop rows); per-sample logstd and loss-sum terms]
//   G2  = (W3^T G3) f'(A2),  G1 = (W2^T G2) f'(A1)
// and the gradients are three products over the tile, dW1' = G1 X'^T,
// dW2' = G2 A1'^T, dW3' = G3 A2'^T: the ones row puts each bias (and the
// logstd and loss sums, as the ones column of G3's extra rows) in a column
// of the same product.  Hidden widths and obs widths are padded to a
// multiple of 4 with zero weights, so padded rows stay 0.
//
// Every product is a register tile: a thread owns 4x4 outputs and reads
// each operand from shared memory as a float4, so one load feeds four
// multiply-adds (two shared-memory loads per multiply-add would cap the
// kernel near 12% of the FFMA rate: an SM serves 32 floats a clock to 128
// FP32 lanes).  The
// gradient accumulators are R such tiles per thread, in registers for the
// whole call, at places fixed by the tile's index; a net with more tiles
// than NT * R splits over gridDim.y / 2 slices, each recomputing the
// forward and backward.  Gradient tiles take rows r, r + nrt, ... and
// columns c, c + nct, ... so that the eight lanes of a float4 phase read
// eight consecutive rows, which the row stride TS + 4 puts on distinct
// banks.
//
// The products use explicit FMA (__fmaf_rn): one rounding per multiply-add,
// at least as accurate as the multiply and add apart.  The library builds
// with -fmad=false for the other kernels, whose bit-equality with their
// plain versions rests on it; K4 was never bit-equal to its plain version
// (other summation orders) and is held to it and to torch.autograd at the
// JAX suite's gradient tolerance.  The losses keep separate roundings.
//
// Weights: each block stages its net's padded weights in shared memory when
// they fit beside the tile rows (the H = 64 and H = 128 main shapes);
// otherwise a pack launch writes the padded layout to device memory and the
// products read it through L1.  No float atomics: each block writes its
// partial gradient entries, and a second launch sums the sample blocks'
// partials in block order, so two launches on one input agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr float HALF_LOG_2PI = 0.918938533204672741780329736406f;

struct UpdateParams {
  int nx, nu, H, mb, relu, n_tiles, ts;
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

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }

// One net's padded sizes and the offsets of its padded weights
// (W1 hp x nxp | W2 hp x hp | W3 nop x hp | b1 hp | b2 hp | b3 nop) and of
// its tile rows in shared memory (rows of ld = ts + 4 floats).
struct Net {
  int nout, nxp, hp, nop, nep, kx, kh;
  int w1, w2, w3, b1, b2, b3, wsize;           // padded weights
  int sw1, sw2, sw3, sb1, sb2, sb3;            // flat segment offsets
  int x, aux, a1, a2, g1, g2, g3, rows;        // tile rows
};

__host__ __device__ inline Net net_layout(int nx, int nu, int H, int net) {
  Net n;
  const Seg S = segments(nx, nu, H);
  n.nout = net ? 1 : nu;
  n.nxp = up4(nx);
  n.hp = up4(H);
  n.nop = up4(n.nout);
  n.nep = up4(net ? 1 : nu + 2);  // actor: nu logstd terms + 2 sums; critic: 1 sum
  n.kx = n.nxp + 4;
  n.kh = n.hp + 4;
  int o = 0;
  n.w1 = o; o += n.hp * n.nxp;
  n.w2 = o; o += n.hp * n.hp;
  n.w3 = o; o += n.nop * n.hp;
  n.b1 = o; o += n.hp;
  n.b2 = o; o += n.hp;
  n.b3 = o; o += n.nop;
  n.wsize = o;
  n.sw1 = net ? S.w1c : S.w1a;
  n.sw2 = net ? S.w2c : S.w2a;
  n.sw3 = net ? S.w3c : S.w3a;
  n.sb1 = net ? S.b1c : S.b1a;
  n.sb2 = net ? S.b2c : S.b2a;
  n.sb3 = net ? S.b3c : S.b3a;
  int r = 0;
  n.x = r; r += n.kx;
  n.aux = r; r += nu + 3;  // act rows, logp_old, ret, adv
  n.a1 = r; r += n.kh;
  n.a2 = r; r += n.kh;
  n.g1 = r; r += n.hp;
  n.g2 = r; r += n.hp;
  n.g3 = r; r += n.nop + n.nep;
  n.rows = r;
  return n;
}

// Gradient tiles of one net: products p0 = G1 X'^T, p1 = G2 A1'^T,
// p2 = G3[:nop] A2'^T, p3 = G3[nop:] times A2's ones column only.
__host__ __device__ inline int net_tiles(const Net& n) {
  return (n.hp / 4) * (n.kx / 4) + (n.hp / 4) * (n.kh / 4) + (n.nop / 4) * (n.kh / 4) + n.nep / 4;
}

// Tile t of a net: its G rows g + (rt + q*nrt)*ld and A rows a + (ct + j*nct)*ld
// (row offsets from the tile-row base), and its product.
struct Tile {
  int prod, rt, nrt, ct, nct, g, a;
};

__host__ __device__ inline Tile tile_of(const Net& n, int t) {
  Tile T;
  const int hr = n.hp / 4;
  const int n0 = hr * (n.kx / 4), n1 = hr * (n.kh / 4), n2 = (n.nop / 4) * (n.kh / 4);
  if (t < n0) {
    T.prod = 0; T.nrt = hr; T.nct = n.kx / 4; T.g = n.g1; T.a = n.x;
  } else if ((t -= n0) < n1) {
    T.prod = 1; T.nrt = hr; T.nct = n.kh / 4; T.g = n.g2; T.a = n.a1;
  } else if ((t -= n1) < n2) {
    T.prod = 2; T.nrt = n.nop / 4; T.nct = n.kh / 4; T.g = n.g3; T.a = n.a2;
  } else {
    t -= n2;
    T.prod = 3; T.nrt = n.nep / 4; T.nct = n.kh / 4; T.g = n.g3 + n.nop; T.a = n.a2;
    T.rt = t;
    T.ct = n.hp % T.nct;  // the ones column hp = ct + (hp / nct) * nct
    return T;
  }
  T.rt = t / T.nct;
  T.ct = t % T.nct;
  return T;
}

// Flat gradient index of entry (row, col) of a product, or -1 for padding.
__device__ inline int entry_index(const Net& n, const Seg& S, int net, int nx, int nu, int H,
                                  int prod, int row, int col) {
  switch (prod) {
    case 0:
      if (row >= H) return -1;
      return col < nx ? n.sw1 + row * nx + col : (col == n.nxp ? n.sb1 + row : -1);
    case 1:
      if (row >= H) return -1;
      return col < H ? n.sw2 + row * H + col : (col == n.hp ? n.sb2 + row : -1);
    case 2:
      if (row >= n.nout) return -1;
      return col < H ? n.sw3 + row * H + col : (col == n.hp ? n.sb3 + row : -1);
    default:
      if (col != n.hp) return -1;
      if (net) return row == 0 ? S.sums + 2 : -1;
      return row < nu ? S.logstd + row : (row < nu + 2 ? S.sums + row - nu : -1);
  }
}

// Net's padded weights from the flat vector, entries i0, i0 + stride, ...
__device__ void pack_net(const float* __restrict__ wflat, const Net& n, int nx, int H,
                         float* __restrict__ dst, int i0, int stride) {
  for (int i = i0; i < n.wsize; i += stride) {
    float v = 0.0f;
    if (i < n.w2) {
      const int r = i / n.nxp, k = i % n.nxp;
      if (r < H && k < nx) v = wflat[n.sw1 + r * nx + k];
    } else if (i < n.w3) {
      const int q = i - n.w2, r = q / n.hp, k = q % n.hp;
      if (r < H && k < H) v = wflat[n.sw2 + r * H + k];
    } else if (i < n.b1) {
      const int q = i - n.w3, r = q / n.hp, k = q % n.hp;
      if (r < n.nout && k < H) v = wflat[n.sw3 + r * H + k];
    } else if (i < n.b2) {
      const int r = i - n.b1;
      if (r < H) v = wflat[n.sb1 + r];
    } else if (i < n.b3) {
      const int r = i - n.b2;
      if (r < H) v = wflat[n.sb2 + r];
    } else {
      const int r = i - n.b3;
      if (r < n.nout) v = wflat[n.sb3 + r];
    }
    dst[i] = v;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

enum { ACT_TANH = 0, ACT_RELU = 1, ACT_NONE = 2 };

__device__ __forceinline__ float act_fn(float z, int act) {
  if (act == ACT_NONE) return z;
  return act == ACT_RELU ? ((z > 0.0f || z != z) ? z : 0.0f) : tanhf(z);  // jnp.maximum keeps NaN
}

// tanh' = 1 - a^2; relu' = [z > 0], and z > 0 iff relu(z) > 0.
__device__ __forceinline__ float act_grad(float a, int relu) {
  return relu ? (a > 0.0f ? 1.0f : 0.0f) : 1.0f - a * a;
}

// Z[r][s] = act(sum_k W[r][k] X[k][s] + b[r]) for rows r < rows (a
// multiple of 4) and the tile's samples; k < K, a multiple of 4, in order.
__device__ __forceinline__ void forward(const float* W, int ldw, int K, const float* X,
                                        const float* b, float* Z, int rows, int ts, int ld,
                                        int act) {
  const int nst = ts / 4, n = (rows / 4) * nst;
  for (int u = threadIdx.x; u < n; u += NT) {
    const int rt = u / nst, s = 4 * (u % nst);
    float c[4][4] = {};
    for (int k = 0; k < K; k += 4) {
      float4 w[4], x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = ld4(W + (4 * rt + i) * ldw + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = ld4(X + (k + j) * ld + s);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wi = comp(w[i], j);
          c[i][0] = __fmaf_rn(wi, x[j].x, c[i][0]);
          c[i][1] = __fmaf_rn(wi, x[j].y, c[i][1]);
          c[i][2] = __fmaf_rn(wi, x[j].z, c[i][2]);
          c[i][3] = __fmaf_rn(wi, x[j].w, c[i][3]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float bi = b[4 * rt + i];
      st4(Z + (4 * rt + i) * ld + s, make_float4(act_fn(c[i][0] + bi, act), act_fn(c[i][1] + bi, act),
                                                 act_fn(c[i][2] + bi, act), act_fn(c[i][3] + bi, act)));
    }
  }
}

// Gout[k][s] = (sum_r W[r][k] G[r][s]) f'(A[k][s]) for k < kdim, r < R (both
// multiples of 4), r in order.
__device__ __forceinline__ void backward(const float* W, int ldw, int R, const float* G,
                                         const float* A, float* Gout, int kdim, int ts, int ld,
                                         int relu) {
  const int nst = ts / 4, n = (kdim / 4) * nst;
  for (int u = threadIdx.x; u < n; u += NT) {
    const int kt = u / nst, s = 4 * (u % nst);
    float c[4][4] = {};
    for (int r = 0; r < R; r += 4) {
      float4 w[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = ld4(W + (r + i) * ldw + 4 * kt);
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = ld4(G + (r + i) * ld + s);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float wa = comp(w[i], a);
          c[a][0] = __fmaf_rn(wa, g[i].x, c[a][0]);
          c[a][1] = __fmaf_rn(wa, g[i].y, c[a][1]);
          c[a][2] = __fmaf_rn(wa, g[i].z, c[a][2]);
          c[a][3] = __fmaf_rn(wa, g[i].w, c[a][3]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 av = ld4(A + (4 * kt + a) * ld + s);
      st4(Gout + (4 * kt + a) * ld + s,
          make_float4(c[a][0] * act_grad(av.x, relu), c[a][1] * act_grad(av.y, relu),
                      c[a][2] * act_grad(av.z, relu), c[a][3] * act_grad(av.w, relu)));
    }
  }
}

// R = 2 (up to 512 gradient tiles a net, the H = 64 shapes) keeps to 128
// registers, so that two blocks share an SM; R = 6 may take 255.
template <int R, bool kSmemW>
__global__ void __launch_bounds__(NT, R == 2 ? 2 : 1) ppo_grads_kernel(const UpdateParams P,
                                                          const float* __restrict__ mb,
                                                          const float* __restrict__ wflat,
                                                          const float* __restrict__ wpad,
                                                          float* __restrict__ partial) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int nx = P.nx, nu = P.nu, H = P.H, tid = threadIdx.x;
  const int net = blockIdx.y & 1, slice = blockIdx.y >> 1;
  const Seg S = segments(nx, nu, H);
  const Net n = net_layout(nx, nu, H, net);
  const int ts = P.ts, ld = ts + 4;

  const float* W;
  float* T;  // tile rows
  if constexpr (kSmemW) {
    pack_net(wflat, n, nx, H, sm, tid, NT);
    W = sm;
    T = sm + n.wsize;
  } else {
    W = wpad + (net ? net_layout(nx, nu, H, 0).wsize : 0);
    T = sm;
  }
  for (int i = tid; i < n.rows * ld; i += NT) T[i] = 0.0f;
  __syncthreads();
  for (int s = tid; s < ts; s += NT) {
    T[(n.x + n.nxp) * ld + s] = 1.0f;
    T[(n.a1 + n.hp) * ld + s] = 1.0f;
    T[(n.a2 + n.hp) * ld + s] = 1.0f;
  }
  const int act = P.relu ? ACT_RELU : ACT_TANH;
  const int n_tiles = net_tiles(n), t0 = slice * NT * R + tid;
  float* X = T + n.x * ld;
  float* AUX = T + n.aux * ld;
  float* A1 = T + n.a1 * ld;
  float* A2 = T + n.a2 * ld;
  float* G1 = T + n.g1 * ld;
  float* G2 = T + n.g2 * ld;
  float* G3 = T + n.g3 * ld;
  const int r_logp = nu, r_ret = nu + 1, r_adv = nu + 2;  // AUX rows after the actions

  float acc[R][16];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[i][e] = 0.0f;

  for (int tile = blockIdx.x; tile < P.n_tiles; tile += gridDim.x) {
    const int base = tile * ts;
    const int count = min(ts, P.mb - base);  // a multiple of 8
    __syncthreads();  // the previous tile's rows are consumed

    // -- load the tile, float4 along samples; padding samples read 0.
    const int nq = ts / 4, n_in = nx + nu + 3;
    for (int o = tid; o < n_in * nq; o += NT) {
      const int f = o / nq, s = 4 * (o % nq);
      const int src = f < nx + nu ? f : f + 1;  // skip the v row
      float* dst = f < nx ? X + f * ld : AUX + (f - nx) * ld;
      const float4 v = s < count ? __ldg(reinterpret_cast<const float4*>(
                                       mb + static_cast<size_t>(src) * P.mb + base + s))
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      st4(dst + s, v);
    }
    __syncthreads();

    // -- forward: two hidden layers, then the outputs (means or value) into G3.
    forward(W + n.w1, n.nxp, n.nxp, X, W + n.b1, A1, n.hp, ts, ld, act);
    __syncthreads();
    forward(W + n.w2, n.hp, n.hp, A1, W + n.b2, A2, n.hp, ts, ld, act);
    __syncthreads();
    forward(W + n.w3, n.hp, n.hp, A2, W + n.b3, G3, n.nop, ts, ld, ACT_NONE);
    __syncthreads();

    // -- per-sample losses and the gradients at the outputs
    // (fast_update.py:142-190); rows nop.. of G3 take the per-sample
    // logstd-gradient and loss-sum terms.
    for (int s = tid; s < ts; s += NT) {
      const bool valid = s < count;
      if (net == 0) {
        float logp = 0.0f;
        for (int i = 0; i < nu; ++i) {
          const float ls = __ldg(wflat + S.logstd + i);
          const float inv_var = expf(-2.0f * ls);
          const float diff = AUX[i * ld + s] - G3[i * ld + s];
          logp = logp + (-0.5f * diff * diff * inv_var - ls - HALF_LOG_2PI);
        }
        const float logp_old = AUX[r_logp * ld + s], adv = AUX[r_adv * ld + s];
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
        const float w_pol = valid ? -P.inv_n * (take1 + (1.0f - take1) * inside) * ratio * adv : 0.0f;
        for (int i = 0; i < nu; ++i) {
          const float ls = __ldg(wflat + S.logstd + i);
          const float inv_var = expf(-2.0f * ls);
          const float diff = AUX[i * ld + s] - G3[i * ld + s];
          G3[i * ld + s] = w_pol * (diff * inv_var);
          G3[(n.nop + i) * ld + s] = w_pol * (diff * diff * inv_var - 1.0f);
        }
        G3[(n.nop + nu) * ld + s] = valid ? min_surr : 0.0f;
        G3[(n.nop + nu + 1) * ld + s] = valid ? logp_old - logp : 0.0f;
      } else {
        const float verr = G3[s] - AUX[r_ret * ld + s];
        G3[s] = valid ? P.inv_n * verr : 0.0f;
        G3[n.nop * ld + s] = valid ? verr * verr : 0.0f;
      }
    }
    __syncthreads();

    // -- backward into both hidden layers.
    backward(W + n.w3, n.hp, n.nop, G3, A2, G2, n.hp, ts, ld, P.relu);
    __syncthreads();
    backward(W + n.w2, n.hp, n.hp, G2, A1, G1, n.hp, ts, ld, P.relu);
    __syncthreads();

    // -- this tile's share of the thread's gradient tiles: acc += G A^T.
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int t = t0 + i * NT;
      if (t < n_tiles) {
        const Tile tl = tile_of(n, t);
        const float* g = T + (tl.g + tl.rt) * ld;
        const float* a = T + (tl.a + tl.ct) * ld;
        const int gs = tl.nrt * ld, as = tl.nct * ld;
#pragma unroll 2
        for (int s = 0; s < ts; s += 4) {
          float4 gv[4], av[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) gv[q] = ld4(g + q * gs + s);
#pragma unroll
          for (int j = 0; j < 4; ++j) av[j] = ld4(a + j * as + s);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float c = acc[i][q * 4 + j];
              c = __fmaf_rn(gv[q].x, av[j].x, c);
              c = __fmaf_rn(gv[q].y, av[j].y, c);
              c = __fmaf_rn(gv[q].z, av[j].z, c);
              acc[i][q * 4 + j] = __fmaf_rn(gv[q].w, av[j].w, c);
            }
        }
      }
    }
  }

  // -- this block's partial gradient entries.
  float* out = partial + static_cast<size_t>(blockIdx.x) * S.ng;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = t0 + i * NT;
    if (t < n_tiles) {
      const Tile tl = tile_of(n, t);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = entry_index(n, S, net, nx, nu, H, tl.prod, tl.rt + q * tl.nrt,
                                    tl.ct + j * tl.nct);
          if (e >= 0) out[e] = acc[i][q * 4 + j];
        }
    }
  }
}

// Both nets' padded weights into device memory, for the shapes whose
// weights do not fit in shared memory.
__global__ void ppo_pack_kernel(int nx, int nu, int H, const float* __restrict__ wflat,
                                float* __restrict__ wpad) {
  const int net = blockIdx.y;
  const Net n = net_layout(nx, nu, H, net);
  pack_net(wflat, n, nx, H, wpad + (net ? net_layout(nx, nu, H, 0).wsize : 0),
           blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
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

using KernelFn = void (*)(const UpdateParams, const float*, const float*, const float*, float*);

KernelFn kernel_for(int r, int smem_w) {
  if (r == 2) return smem_w ? ppo_grads_kernel<2, true> : ppo_grads_kernel<2, false>;
  return smem_w ? ppo_grads_kernel<6, true> : ppo_grads_kernel<6, false>;
}

}  // namespace

extern "C" int ppo_grads_api_version() { return 2; }

// The launch plan of one shape, worked out once (the wrapper caches it):
// plan[0] gradient entries, [1] sample blocks, [2] slices per net, [3]
// samples per tile, [4] gradient tiles per thread, [5] weights staged in
// shared memory, [6] dynamic shared memory in bytes, [7] floats of the
// padded weights in device memory (0 when staged).  Sets the kernel
// instance's shared-memory attribute.  Returns -1 for a shape outside the
// scope.
extern "C" int ppo_grads_plan(int nx, int nu, int H, int mb, int* plan) {
  if (nx < 1 || nx > 128 || nu < 1 || nu > 8 || H < 1 || H > 256 || mb <= 0 || mb % 8) return -1;
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Net a = net_layout(nx, nu, H, 0), c = net_layout(nx, nu, H, 1);
  const int tiles = net_tiles(a) > net_tiles(c) ? net_tiles(a) : net_tiles(c);
  const int r = tiles <= 2 * NT ? 2 : 6;
  const int slices = (tiles + NT * r - 1) / (NT * r);
  const int wmax = a.wsize > c.wsize ? a.wsize : c.wsize;
  const int rows = a.rows > c.rows ? a.rows : c.rows;
  int ts = 0, smem_w = 0, bytes = 0;
  for (int sw = 1; sw >= 0 && !ts; --sw)
    for (int t = 64; t >= 32 && !ts; t /= 2) {
      const long b = 4L * ((sw ? wmax : 0) + static_cast<long>(rows) * (t + 4));
      if (b <= max_smem) { ts = t; smem_w = sw; bytes = static_cast<int>(b); }
    }
  if (!ts) return -1;
  // The attribute is the instance's, shared by every shape it runs: raise it
  // to the card's limit, not to this shape's need.
  const KernelFn fn = kernel_for(r, smem_w);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (mb + ts - 1) / ts;
  int nsb = sms * (per_sm > 0 ? per_sm : 1) / (2 * slices);
  nsb = nsb < 1 ? 1 : (nsb > n_tiles ? n_tiles : nsb);
  plan[0] = segments(nx, nu, H).ng;
  plan[1] = nsb;
  plan[2] = slices;
  plan[3] = ts;
  plan[4] = r;
  plan[5] = smem_w;
  plan[6] = bytes;
  plan[7] = smem_w ? 0 : a.wsize + c.wsize;
  return 0;
}

extern "C" int ppo_grads(const int* plan, int nx, int nu, int H, int mb, int relu, float clip_lo,
                         float clip_hi, float inv_n, const void* mb_ptr, const void* wflat,
                         void* wpad, void* partial, void* out, void* stream) {
  UpdateParams P;
  P.nx = nx;
  P.nu = nu;
  P.H = H;
  P.mb = mb;
  P.relu = relu;
  P.ts = plan[3];
  P.n_tiles = (mb + P.ts - 1) / P.ts;
  P.clip_lo = clip_lo;
  P.clip_hi = clip_hi;
  P.inv_n = inv_n;
  const int ng = plan[0], nsb = plan[1];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(wflat);
  float* wp = static_cast<float*>(wpad);
  if (!plan[5]) {
    ppo_pack_kernel<<<dim3(8, 2), 256, 0, st>>>(nx, nu, H, wf, wp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel_for(plan[4], plan[5])<<<dim3(nsb, 2 * plan[2]), NT, plan[6], st>>>(
      P, static_cast<const float*>(mb_ptr), wf, wp, static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ppo_grads_reduce_kernel<<<(ng + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial),
                                                  static_cast<float*>(out), ng, nsb);
  return static_cast<int>(cudaGetLastError());
}
