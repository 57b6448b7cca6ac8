// adaQN projection on Hopper: one pass over the pair memory gives
//
//     wg  = W g          [2m],   W = [S; Y]  ([2m, n])
//     ydg = (Y o D) g    [m]
//     ydy = (Y o D) Y^T  [m, m],  D = diag(d)
//
// and Y o D is never stored.  Replaces the Pallas TPU kernel
// stochqn_tpu/ops/pallas/two_loop_kernel.py::project_adaqn (pallas_call at
// :390).  Every input is float32 and every sum is accumulated in float32.
// d may have either sign (with h0_exact_reference it is the rescaled
// gradient).
//
// What bounds it on the card: bytes.  It reads (2m + 2) n floats, 25.7 MB at
// the flagship shape (m = 10, n = 292,083), and does about (6m + 2m^2) n
// FLOPs, about 3 FLOP per byte, under the H100's ~20 FLOP/byte float32
// balance point.
//
// What the design does about it.  The TPU kernel walks its grid in order and
// accumulates all three outputs in VMEM across grid steps; on Hopper blocks
// run in parallel and in no order, so the work is two launches:
//
//   1. partials: each block stages tiles of columns of S, Y, g and d in
//      shared memory (2m + 2 rows of 256 columns, 22.6 KB at m = 10), read
//      from device memory once and coalesced, with cp.async so that all of
//      a thread's copies of a tile are in flight at once (one memory
//      latency per tile, not one per row).  The grid is one wave of
//      kBlocksPerSm blocks per SM, each taking a run of consecutive
//      tiles.  The K = 3m + m(m+1)/2 sums
//      (ydy by its symmetry) are split over the threads: thread t owns
//      output t mod K over one column slice of the tile, so no thread holds
//      more than 3 accumulators whatever m is.  Every sum runs the same
//      branch-free loop, (a[c] * w[c]) * b[c], with w the staged d or a
//      row of ones, so the sums with and without d in one warp do not
//      diverge.  At the end the slices of each output are summed in a
//      fixed order into partials[k, block].
//   2. reduce: one warp per output sums its partials in a fixed order and
//      writes wg, ydg and both halves of ydy.
//
// No atomics, so every run gives the same result.  The ragged edge is
// masked (zeros staged past n); S, Y, d and g are never padded or copied.
// Wide loads, TMA and fusing the pass into the expand of the two-loop are
// later work.
//
// Plain C interface, loaded with ctypes.  Both launches are on the caller's
// stream; the function returns cudaGetLastError() after them.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMem = 32;    // largest m (pairs) the kernel takes
constexpr int kMaxItems = 3;   // (output, column slice) items per thread
constexpr int kBlocksPerSm = 4;  // pass-1 occupancy the grid is sized for
constexpr size_t kSmemBytes = 48 * 1024;  // static shared memory of a launch
constexpr int kReduceWarps = kThreads / 32;

__host__ __device__ constexpr int num_outputs(int m) {
  return 3 * m + m * (m + 1) / 2;
}
// Every m up to kMaxMem fits: the items in the threads' registers, and a
// 128-column tile with its row of ones in shared memory.
static_assert(num_outputs(kMaxMem) <= kMaxItems * kThreads, "items");
static_assert(sizeof(float) * ((2 * kMaxMem + 2) * 129 + 128) <= kSmemBytes,
              "shared memory");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Output k sums (row_a[c] * (use_d ? d[c] : 1)) * row_b[c] over the columns,
// where the staged rows are S (0..m-1), Y (m..2m-1), g (2m) and d (2m+1):
//   k < 2m:       wg[k]     = W[k] . g
//   k < 3m:       ydg[r]    = (Y[r] o d) . g,      r = k - 2m
//   otherwise:    ydy[r, q] = (Y[r] o d) . Y[q],   r <= q, row-major over
//                 the upper triangle.
struct Term {
  int ra;
  int rb;
  bool use_d;
};

__host__ __device__ inline Term term(int k, int m) {
  if (k < 2 * m) return {k, 2 * m, false};
  if (k < 3 * m) return {k - m, 2 * m, true};
  int p = k - 3 * m;
  int r = 0;
  while (p >= m - r) {
    p -= m - r;
    ++r;
  }
  return {m + r, m + r + p, true};
}

// Pass 1.  Block b handles tiles b * tiles_per_block ... of TILE columns;
// partials[k * gridDim.x + b] is its sum for output k.
template <int TILE>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    adaqn_partials(const float* __restrict__ s, const float* __restrict__ y,
                   const float* __restrict__ d, const float* __restrict__ g,
                   int m, int64_t n, int tiles_per_block, int slices,
                   float* __restrict__ partials) {
  extern __shared__ float tile[];
  constexpr int kLd = TILE + 1;  // padded: rows one apart are a bank apart
  const int rows = 2 * m + 2;
  const int K = num_outputs(m);
  const int items = K * slices;

  Term t[kMaxItems];
  int slice[kMaxItems];
  float acc[kMaxItems];
#pragma unroll
  for (int i = 0; i < kMaxItems; ++i) {
    const int it = threadIdx.x + i * kThreads;
    t[i] = term(it < items ? it % K : 0, m);
    slice[i] = it < items ? it / K : 0;
    acc[i] = 0.f;
  }
  const float* dd = tile + (2 * m + 1) * kLd;
  __shared__ float ones[TILE];
  for (int c = threadIdx.x; c < TILE; c += kThreads) ones[c] = 1.f;

  const int64_t first = static_cast<int64_t>(blockIdx.x) * tiles_per_block;
  for (int tt = 0; tt < tiles_per_block; ++tt) {
    const int64_t col0 = (first + tt) * TILE;
    if (col0 >= n) break;  // the same for every thread of the block
    __syncthreads();       // the previous tile is read by everyone
    for (int idx = threadIdx.x; idx < rows * TILE; idx += kThreads) {
      const int r = idx / TILE;
      const int c = idx - r * TILE;
      const int64_t j = col0 + c;
      float* dst = tile + r * kLd + c;
      if (j < n) {
        const float* src = r < m       ? s + r * n + j
                           : r < 2 * m ? y + (r - m) * n + j
                           : r == 2 * m ? g + j
                                        : d + j;
        __pipeline_memcpy_async(dst, src, sizeof(float));
      } else {
        *dst = 0.f;
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i) {
      if (threadIdx.x + i * kThreads < items) {
        const float* a = tile + t[i].ra * kLd;
        const float* b = tile + t[i].rb * kLd;
        const float* w = t[i].use_d ? dd : ones;  // a * 1 is exact
        float sum = acc[i];
#pragma unroll 4
        for (int c = slice[i]; c < TILE; c += slices) {
          sum = fmaf(a[c] * w[c], b[c], sum);
        }
        acc[i] = sum;
      }
    }
  }

  // Sum the column slices of each output, in slice order.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxItems; ++i) {
    const int it = threadIdx.x + i * kThreads;
    if (it < items) tile[it] = acc[i];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float v = 0.f;
    for (int sl = 0; sl < slices; ++sl) v += tile[sl * K + k];
    partials[static_cast<int64_t>(k) * gridDim.x + blockIdx.x] = v;
  }
}

// Pass 2.  Warp w of block b sums output k = b * kReduceWarps + w over the
// pass-1 blocks (lanes stride over them, then a fixed shuffle tree).
// out = [wg (2m) | ydg (m) | ydy (m * m, row-major)].
__global__ void __launch_bounds__(kThreads)
    adaqn_reduce(const float* __restrict__ partials, int num_partials, int m,
                 float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kReduceWarps + (threadIdx.x >> 5);
  if (k >= num_outputs(m)) return;  // whole warps leave together
  const float* p = partials + static_cast<int64_t>(k) * num_partials;
  float v = 0.f;
  for (int b = lane; b < num_partials; b += 32) v += p[b];
  v = warp_sum(v);
  if (lane != 0) return;
  if (k < 3 * m) {
    out[k] = v;
  } else {
    const Term tm = term(k, m);
    const int r = tm.ra - m;
    const int q = tm.rb - m;
    out[3 * m + r * m + q] = v;
    out[3 * m + q * m + r] = v;
  }
}

// Columns per staged tile: 256 while the 2m + 2 padded rows and the row of
// ones fit the static shared-memory limit (m <= 22), else 128.
inline int tile_cols(int m) {
  return sizeof(float) * ((2 * m + 2) * 257 + 256) <= kSmemBytes ? 256 : 128;
}

// The pass-1 grid: one wave of kBlocksPerSm blocks per SM, each taking a run
// of consecutive tiles.
struct Grid {
  int tile;
  int tiles_per_block;
  int blocks;
};

inline Grid grid(int m, int64_t n, int num_sms) {
  const int tile = tile_cols(m);
  const int64_t tiles = (n + tile - 1) / tile;
  const int64_t wave = static_cast<int64_t>(kBlocksPerSm) * num_sms;
  const int64_t per_block = (tiles + wave - 1) / wave;
  return {tile, static_cast<int>(per_block),
          static_cast<int>((tiles + per_block - 1) / per_block)};
}

template <int TILE>
int launch(const float* s, const float* y, const float* d, const float* g,
           float* out, float* partials, int m, int64_t n, Grid gr,
           cudaStream_t stream) {
  const int K = num_outputs(m);
  const int slices = K >= kThreads ? 1 : kThreads / K;
  const size_t smem = sizeof(float) * (2 * m + 2) * (TILE + 1);
  adaqn_partials<TILE><<<gr.blocks, kThreads, smem, stream>>>(
      s, y, d, g, m, n, gr.tiles_per_block, slices, partials);
  adaqn_reduce<<<(K + kReduceWarps - 1) / kReduceWarps, kThreads, 0,
                 stream>>>(partials, gr.blocks, m, out);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int m, long long n, int num_sms) {
  return m >= 1 && m <= kMaxMem && n >= 1 && num_sms >= 1;
}

}  // namespace

extern "C" {

// Floats of scratch adaqn_project needs for these m and n on a card with
// num_sms SMs (one partial sum per output and pass-1 block); 0 if the
// arguments are out of range.
long long adaqn_project_scratch(int m, long long n, int num_sms) {
  if (!valid(m, n, num_sms)) return 0;
  return static_cast<long long>(num_outputs(m)) * grid(m, n, num_sms).blocks;
}

// wg = [S; Y] g, ydg = (Y o d) g, ydy = (Y o d) Y^T in one pass.
//   s, y     [m, n] float32 row-major, 1 <= m <= 32;  d, g [n] float32
//   out      float32, 3m + m*m: wg (2m) | ydg (m) | ydy (m x m)
//   scratch  float32, adaqn_project_scratch(m, n, num_sms) floats
//   num_sms  SMs of the card the stream belongs to (sizes the grid)
// Returns cudaGetLastError() after the launches (0 on success).
int adaqn_project(const float* s, const float* y, const float* d,
                  const float* g, float* out, float* scratch, int m,
                  long long n, int num_sms, void* stream) {
  if (!valid(m, n, num_sms)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Grid gr = grid(m, n, num_sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return gr.tile == 256
             ? launch<256>(s, y, d, g, out, scratch, m, n, gr, st)
             : launch<128>(s, y, d, g, out, scratch, m, n, gr, st);
}

}  // extern "C"
