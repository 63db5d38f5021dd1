// The trainer's minibatch layout: K4's batch-last minibatches gathered in
// one pass from the packed rows and one shuffle's sample indices.
//
// Replaces no TPU kernel.  The JAX package gathers the rows of each
// minibatch with XLA (safe_control_gym_tpu/controllers/ppo.py, update);
// the port did it as two PyTorch copies, a row gather packed[idx] into
// (n_mini, m, F) and .transpose(1, 2).contiguous() into K4's (n_mini, F, m),
// which ran at about 270 and 350 GB/s on an H100.  Plain version:
// safe_control_gym_torch/parallel/fast_update.py::minibatch_layout_plain.
//
// out[i, f, j] = packed[idx[i * ld + j], f] for the (N, F) float32 packed
// rows, the (n_mini, m) int64 sample indices with row stride ld (a column
// slice of an epoch's index is one rank's share under data parallelism) and
// the (n_mini, F, m) output.  A copy: the output holds the input's bits.
//
// Bound on an H100: bytes.  Each packed row is read once from a random
// place, in whole 32-B sectors (an 80-B row, F = 20, spans three, a 36-B
// row, F = 9, two), each index once and each output float written once:
// at N = 4,194,304 and F = 20 that is 403 + 34 + 335 MB an epoch, 0.23 ms
// at 3.35 TB/s.
//
// Design.  A block takes TJ consecutive columns of one minibatch.  It reads
// their indices into shared memory, then the rows in pieces of V floats
// (V = 4, 2 or 1: the widest that the row width and the buffer's alignment
// allow), consecutive threads on consecutive pieces of a row, so that a
// warp's load covers a few whole rows; each thread issues U loads before it
// stores any, to keep enough bytes in flight for random rows.  The pieces
// go to shared memory transposed, F rows of TJ + 1 floats (the pad puts the
// floats of one piece on different banks), and the block then writes F
// runs of TJ consecutive floats, one coalesced run per output row.  TJ is
// 256 where F rows of it fit in 32 KB of shared memory, halved down to 32
// for wide rows and for short minibatches (SafeExplorerPPO's m = 64); the
// last tile of a minibatch may be short.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int U = 4;           // loads a thread issues before it stores them
constexpr int MAX_TJ = 256;    // columns per block
constexpr int MAX_F = 140;     // K4's widest row: 128 obs + 8 act + 4
constexpr long SMEM_ROWS = 32 * 1024;  // bytes of the transposed tile

template <int V> struct Piece;
template <> struct Piece<1> {
  using T = float;
  __device__ static float at(const float& v, int) { return v; }
};
template <> struct Piece<2> {
  using T = float2;
  __device__ static float at(const float2& v, int c) { return c ? v.y : v.x; }
};
template <> struct Piece<4> {
  using T = float4;
  __device__ static float at(const float4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
};

template <int V>
__global__ void __launch_bounds__(NT) minibatch_layout_kernel(
    const float* __restrict__ packed, const int64_t* __restrict__ idx, int64_t ld,
    float* __restrict__ out, int64_t N, int F, int m, int tiles, int lg_tj) {
  using Vec = typename Piece<V>::T;
  extern __shared__ float cols[];  // F rows of tj + 1 floats
  __shared__ int64_t rows[MAX_TJ];  // float offset of each column's packed row
  const int tj = 1 << lg_tj, lds = tj + 1;
  const int i = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - i * tiles) * tj;
  const int n = m - j0 < tj ? m - j0 : tj;  // columns of this tile
  for (int jj = threadIdx.x; jj < n; jj += NT) {
    const int64_t r = idx[i * ld + j0 + jj];
    // An index outside the rows faults the launch, as PyTorch's own
    // gather does with its device assert, rather than read stray memory.
    if (static_cast<uint64_t>(r) >= static_cast<uint64_t>(N)) __trap();
    rows[jj] = r * F;
  }
  __syncthreads();
  const int fv = F / V, total = n * fv;  // pieces a row; pieces in the tile
  for (int e0 = threadIdx.x; e0 < total; e0 += NT * U) {
    Vec v[U];
    int jj[U], q[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT;
      jj[u] = e / fv;
      q[u] = e - jj[u] * fv;
      if (e < total) v[u] = *reinterpret_cast<const Vec*>(packed + rows[jj[u]] + q[u] * V);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e0 + u * NT < total)
#pragma unroll
        for (int c = 0; c < V; ++c) cols[(q[u] * V + c) * lds + jj[u]] = Piece<V>::at(v[u], c);
  }
  __syncthreads();
  float* o = out + static_cast<int64_t>(i) * F * m + j0;
  for (int e = threadIdx.x; e < F * tj; e += NT) {
    const int f = e >> lg_tj, jj = e & (tj - 1);
    if (jj < n) o[static_cast<int64_t>(f) * m + jj] = cols[f * lds + jj];
  }
}

}  // namespace

// packed (N, F) float32 rows, idx (n_mini, m) int64 with row stride ld,
// out (n_mini, F, m).  Returns -1 for a shape outside the kernel's scope
// (F above MAX_F, m or n_mini below 1), else cudaGetLastError() after the
// launch.
extern "C" int minibatch_layout(const void* packed, const void* idx, int64_t ld, void* out,
                                int64_t N, int F, int n_mini, int m, void* stream) {
  if (F < 1 || F > MAX_F || n_mini < 1 || m < 1 || N < 1) return -1;
  // The widest piece that divides the row and keeps every row's address
  // aligned to it.
  const uintptr_t base = reinterpret_cast<uintptr_t>(packed);
  const int v = (F % 4 == 0 && base % 16 == 0) ? 4 : (F % 2 == 0 && base % 8 == 0) ? 2 : 1;
  int lg = 8;
  while (lg > 5 && 4L * F * ((1 << lg) + 1) > SMEM_ROWS) --lg;
  while (lg > 5 && (1 << (lg - 1)) >= m) --lg;
  const int tj = 1 << lg;
  const int tiles = (m + tj - 1) / tj;
  const long blocks = static_cast<long>(tiles) * n_mini;
  if (blocks > 0x7fffffffL) return -1;
  const size_t smem = 4 * static_cast<size_t>(F) * (tj + 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(packed);
  const int64_t* x = static_cast<const int64_t*>(idx);
  float* o = static_cast<float*>(out);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (v == 4)
    minibatch_layout_kernel<4><<<grid, NT, smem, st>>>(p, x, ld, o, N, F, m, tiles, lg);
  else if (v == 2)
    minibatch_layout_kernel<2><<<grid, NT, smem, st>>>(p, x, ld, o, N, F, m, tiles, lg);
  else
    minibatch_layout_kernel<1><<<grid, NT, smem, st>>>(p, x, ld, o, N, F, m, tiles, lg);
  return static_cast<int>(cudaGetLastError());
}
