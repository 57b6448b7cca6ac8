// The grouped matrix product of a mixture of experts on Hopper, and its
// weight gradient:
//
//     y[r]    = x[r] @ w[g]                        for offsets[g] <= r < offsets[g + 1]
//     dw[g]   = a[rows of g]^T @ c[rows of g]
//
// No TPU kernel stands behind it: the routed experts of a model trained on
// the pytree path need it (stochqn_tpu_torch/models/deepseek_v2.py).  Rows
// are sorted by group (expert) on the device and the offsets stay there, so
// a routing that changes from one call to the next needs neither a host read
// nor new shapes, and a CUDA graph that holds these launches replays any
// routing.
//
// Float32 throughout, with IEEE products (fused multiply-adds on the CUDA
// cores, never TF32): the precision of the configuration that runs it.
//
// What bounds it on the card: operations.  At the shapes that use it (a few
// hundred rows a group, K and N of 1,408 and 2,048) each weight element is
// used by every row of its group, far above the H100's ~20 FLOP/byte float32
// balance point.  The design is the classic register-blocked SIMT product:
// a block of 256 threads owns a 128 x 128 tile of the output, each thread an
// 8 x 8 patch of it (two 4 x 4 quadrants, so a warp's 16-byte reads of the
// shared tiles hit distinct banks), and the reduction walks in slices of 8
// through two shared buffers: the next slice's global loads are in flight
// in registers while the current one is multiplied, and one barrier a slice
// separates the buffers' uses.  Two blocks share an SM (at most 128
// registers a thread): with one, the rows product took 1.02 ms at the
// model's shapes, with two 0.77 ms (H100, PERF.md).
//
// Both entry points are the same tile product over another indexing:
//   rows:  output tile (rows of group g, columns of w[g]), reduction over K;
//          a program per (group, row block, column block), row blocks
//          enough for the largest group the caller allows; a block that
//          starts past its group's last row exits at once;
//   wgrad: output tile (K rows, N columns) of group g, reduction over the
//          group's rows, read from the device offsets; an empty group
//          writes zeros.
// Every operand is read through its strides, so a transposed weight (the
// backward's w^T) or a strided tangent needs no copy.  A tile is loaded
// with consecutive threads along whichever of its axes has stride 1, so
// the loads are coalesced either way; which axis that is, is fixed at
// compile time (four instantiations of each kernel, one chosen at launch).
// The rows of no group are left as the caller gives them (the wrapper
// passes zeros).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;       // output rows a block
constexpr int kBN = 128;       // output columns a block
constexpr int kBK = 8;         // reduction slice
constexpr int kThreads = 256;  // 16 x 16 threads, an 8 x 8 patch each
constexpr int kPad = 4;        // keeps a slice's rows in distinct banks
constexpr int kLoads = kBM * kBK / kThreads;  // elements a thread loads
static_assert(kBM == kBN && kBM == 128 && kThreads == 256,
              "the 8 x 8 patches and the loads assume these sizes");

// Elements (i, r) of one operand at p[i * si + r * sr], rows i counted from
// the tile's first, read as a kTile x kBK tile into shared memory laid out
// [kBK][kTile + kPad].  kFastR: stride 1 along r, so consecutive threads
// walk r; else they walk i.
template <int kTile, bool kFastR>
struct Tile {
  const float* p;  // the tile's row 0
  long long si, sr;
  int rows;        // live rows of the tile

  __device__ static void where(int q, int& i, int& r) {
    const int t = threadIdx.x;
    if (kFastR) {
      r = t % kBK;
      i = t / kBK + q * (kThreads / kBK);
    } else {
      i = t % kTile;
      r = t / kTile + q * (kThreads / kTile);
    }
  }

  __device__ void load(long long r0, long long r1, float (&v)[kLoads]) const {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      int i, r;
      where(q, i, r);
      const long long gr = r0 + r;
      v[q] = (i < rows && gr < r1) ? p[i * si + gr * sr] : 0.0f;
    }
  }

  __device__ static void store(const float (&v)[kLoads],
                               float (*s)[kTile + kPad]) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      int i, r;
      where(q, i, r);
      s[r][i] = v[q];
    }
  }
};

__device__ inline int live(long long from, long long end, int tile) {
  const long long n = end - from;
  return n <= 0 ? 0 : (n < tile ? static_cast<int>(n) : tile);
}

// C[i, j] = sum over r0 <= r < r1 of A(i, r) B(r, j) for the block's tile
// (a.rows x b.rows live), written to c[i * sci + j * scj], i and j counted
// from the tile's first row and column.
template <bool kFastA, bool kFastB>
__device__ void tile_product(const Tile<kBM, kFastA>& a,
                             const Tile<kBN, kFastB>& b, long long r0,
                             long long r1, float* c, long long sci,
                             long long scj) {
  __shared__ __align__(16) float as[2][kBK][kBM + kPad];
  __shared__ __align__(16) float bs[2][kBK][kBN + kPad];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.0f;

  float va[kLoads], vb[kLoads];
  const long long slices = r1 > r0 ? (r1 - r0 + kBK - 1) / kBK : 0;
  if (slices > 0) {
    a.load(r0, r1, va);
    b.load(r0, r1, vb);
    a.store(va, as[0]);
    b.store(vb, bs[0]);
  }
  __syncthreads();
  for (long long s = 0; s < slices; ++s) {
    const int cur = static_cast<int>(s & 1);
    const bool more = s + 1 < slices;
    if (more) {
      a.load(r0 + (s + 1) * kBK, r1, va);
      b.load(r0 + (s + 1) * kBK, r1, vb);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[cur][k][64 + tx * 4]);
      const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(ra[u], rb[v], acc[u][v]);
    }
    if (more) {
      a.store(va, as[cur ^ 1]);
      b.store(vb, bs[cur ^ 1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int i = u < 4 ? ty * 4 + u : 64 + ty * 4 + u - 4;
    if (i >= a.rows) continue;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int j = v < 4 ? tx * 4 + v : 64 + tx * 4 + v - 4;
      if (j < b.rows) c[i * sci + j * scj] = acc[u][v];
    }
  }
}

// Each kernel is built for the four ways its operands can be laid out
// (which axis of each has stride 1): the loads' mapping is then fixed at
// compile time, which keeps the registers under 128 a thread, so two blocks
// share an SM.
template <bool kFastA, bool kFastB>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_mm_rows(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ y, const long long* __restrict__ off,
                    int blocks, long long K, long long N, long long sxm,
                    long long sxk, long long swg, long long swk, long long swn,
                    long long sym, long long syn) {
  const int g = static_cast<int>(blockIdx.x) / blocks;
  const long long start = off[g], end = off[g + 1];
  const long long row0 =
      start + static_cast<long long>(blockIdx.x % blocks) * kBM;
  if (row0 >= end) return;
  const long long col0 = static_cast<long long>(blockIdx.y) * kBN;
  const Tile<kBM, kFastA> a{x + row0 * sxm, sxm, sxk, live(row0, end, kBM)};
  // B(r, j) = w[g][r, j]: its rows are the columns j, its r is k
  const Tile<kBN, kFastB> b{w + g * swg + col0 * swn, swn, swk,
                            live(col0, N, kBN)};
  tile_product(a, b, 0, K, y + row0 * sym + col0 * syn, sym, syn);
}

template <bool kFastA, bool kFastB>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_mm_wgrad(const float* __restrict__ a, const float* __restrict__ c,
                     float* __restrict__ out, const long long* __restrict__ off,
                     long long K, long long N, long long sam, long long sak,
                     long long scm, long long scn) {
  const int g = static_cast<int>(blockIdx.x);
  const long long start = off[g], end = off[g + 1];
  const long long i0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long j0 = static_cast<long long>(blockIdx.z) * kBN;
  // A(i, r) = a[r, i], B(r, j) = c[r, j], r over the group's rows
  const Tile<kBM, kFastA> ta{a + i0 * sak, sak, sam, live(i0, K, kBM)};
  const Tile<kBN, kFastB> tc{c + j0 * scn, scn, scm, live(j0, N, kBN)};
  tile_product(ta, tc, start, end, out + g * K * N + i0 * N + j0, N, 1);
}

template <bool kFastA, bool kFastB>
int launch_rows(dim3 grid, cudaStream_t stream, const float* x,
                const float* w, float* y, const long long* off, int blocks,
                long long K, long long N, long long sxm, long long sxk,
                long long swg, long long swk, long long swn, long long sym,
                long long syn) {
  grouped_mm_rows<kFastA, kFastB><<<grid, kThreads, 0, stream>>>(
      x, w, y, off, blocks, K, N, sxm, sxk, swg, swk, swn, sym, syn);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFastA, bool kFastB>
int launch_wgrad(dim3 grid, cudaStream_t stream, const float* a,
                 const float* c, float* out, const long long* off,
                 long long K, long long N, long long sam, long long sak,
                 long long scm, long long scn) {
  grouped_mm_wgrad<kFastA, kFastB><<<grid, kThreads, 0, stream>>>(
      a, c, out, off, K, N, sam, sak, scm, scn);
  return static_cast<int>(cudaGetLastError());
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// y[r] = x[r] @ w[g] for the rows offsets[g] <= r < offsets[g + 1] of each
// group g < groups; the rows of no group are left as they are.
//   x [M, K], w [groups, K, N], y [M, N], all float32 and read through
//   their strides (in elements); offsets [groups + 1] int64, ascending, on
//   the device; max_rows the most rows a group may hold (the grid is sized
//   by min(max_rows, M)).
// Returns the launch's error code (0 on success).
int grouped_mm_rows_launch(const float* x, const float* w, float* y,
                           const long long* offsets, int groups,
                           long long max_rows, long long M, long long K,
                           long long N, long long sxm, long long sxk,
                           long long swg, long long swk, long long swn,
                           long long sym, long long syn, void* stream) {
  if (groups <= 0 || M <= 0 || N <= 0) return 0;
  const long long rows = max_rows < M ? max_rows : M;
  const long long blocks = rows > 0 ? cdiv(rows, kBM) : 1;
  const long long nb = cdiv(N, kBN);
  if (groups * blocks > 0x7fffffffLL || nb > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(groups * blocks),
                  static_cast<unsigned>(nb));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(blocks);
  if (sxk == 1)
    return swk == 1 ? launch_rows<true, true>(grid, st, x, w, y, offsets, b,
                                              K, N, sxm, sxk, swg, swk, swn,
                                              sym, syn)
                    : launch_rows<true, false>(grid, st, x, w, y, offsets, b,
                                               K, N, sxm, sxk, swg, swk, swn,
                                               sym, syn);
  return swk == 1 ? launch_rows<false, true>(grid, st, x, w, y, offsets, b, K,
                                             N, sxm, sxk, swg, swk, swn, sym,
                                             syn)
                  : launch_rows<false, false>(grid, st, x, w, y, offsets, b,
                                              K, N, sxm, sxk, swg, swk, swn,
                                              sym, syn);
}

// out[g] = a[rows of g]^T @ c[rows of g] for each group g < groups (zeros
// for an empty group).
//   a [M, K], c [M, N] float32 read through their strides; out
//   [groups, K, N] float32, contiguous; offsets as above.
// Returns the launch's error code (0 on success).
int grouped_mm_wgrad_launch(const float* a, const float* c, float* out,
                            const long long* offsets, int groups, long long K,
                            long long N, long long sam, long long sak,
                            long long scm, long long scn, void* stream) {
  if (groups <= 0 || K <= 0 || N <= 0) return 0;
  const long long kb = cdiv(K, kBM), nb = cdiv(N, kBN);
  if (groups > 0x7fffffff || kb > 65535 || nb > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(kb),
                  static_cast<unsigned>(nb));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // A(i, r) = a[r, i] has stride 1 along r where sam is 1
  if (sam == 1)
    return scm == 1 ? launch_wgrad<true, true>(grid, st, a, c, out, offsets,
                                               K, N, sam, sak, scm, scn)
                    : launch_wgrad<true, false>(grid, st, a, c, out, offsets,
                                                K, N, sam, sak, scm, scn);
  return scm == 1 ? launch_wgrad<false, true>(grid, st, a, c, out, offsets, K,
                                              N, sam, sak, scm, scn)
                  : launch_wgrad<false, false>(grid, st, a, c, out, offsets,
                                               K, N, sam, sak, scm, scn);
}

}  // extern "C"
