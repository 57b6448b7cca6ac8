// Two-loop projection on Hopper: one pass over the pair memory gives
//
//     wg   = W g     [2m]
//     gram = W W^T   [2m, 2m],   W = [S; Y]  ([2m, n])
//
// Replaces the Pallas TPU kernel
// stochqn_tpu/ops/pallas/two_loop_kernel.py::project (pallas_call at :85).
// Every input is float32 and every sum is accumulated in float32 (no TF32
// tensor-core products: they would miss the tolerance the kernel is held
// to).
//
// What bounds it on the card: bytes, if the sums are kept off the critical
// path.  It reads (2m + 1) n floats, 24.5 MB at the flagship shape (m = 10,
// n = 292,083), and needs 2m + m(2m + 1) = 230 sums per column there with
// the Gram's symmetry used, about 5 FLOP per byte, under the H100's
// ~20 FLOP/byte float32 balance point.  One sum per thread, as the
// neighbouring project_adaqn.cu does, would read two shared-memory words
// per multiply-add and make shared memory the limit.
//
// What the design does about it.  g is treated as one more row: with
// R = [S; Y; g] ([2m + 1, n]) both outputs are the upper triangle of
// R R^T.  The TPU kernel walks its grid in order and accumulates in VMEM
// across grid steps; on Hopper blocks run in parallel and in no order, so
// the work is two launches:
//
//   1. partials: each block stages tiles of columns of R in shared memory
//      (read from device memory once, coalesced, with cp.async so that all
//      of a thread's copies of a tile are in flight at once).  The upper
//      triangle of R R^T is cut into 4 x 4 patches; a warp owns up to two
//      patches and each lane keeps its 16 sums per patch in registers over
//      its columns of the tile: 8 shared-memory words per 16 multiply-adds,
//      conflict-free (the lanes read neighbouring columns of one row).
//      The grid is one wave of blocks, each taking a run of consecutive
//      tiles; where m is so large that a block's warps cannot hold all the
//      patches (m > 13), gridDim.y splits the patches and each y re-stages
//      the tiles.  At the end every warp sums its lanes with a fixed
//      shuffle tree into partials[patch, entry, block].
//   2. reduce: one warp per output entry sums its partials over the blocks
//      in a fixed order and writes wg and both halves of gram.
//
// No atomics, so every run gives the same result.  The ragged edge is
// masked (zeros staged past n); S, Y and g are never padded or copied.
// Wide copies and double-buffered tiles are later work.
//
// Plain C interface, loaded with ctypes.  Both launches are on the caller's
// stream; the function returns cudaGetLastError() after them.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxMem = 32;         // largest m (pairs) the kernel takes
constexpr int kPatch = 4;           // a lane's register patch: 4 x 4 sums
constexpr int kEntries = kPatch * kPatch;
constexpr int kPatchesPerWarp = 2;
constexpr int kMaxWarps = 16;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr size_t kSmemBytes = 48 * 1024;  // dynamic shared memory of a launch
constexpr int kReduceThreads = 256;
constexpr int kReduceWarps = kReduceThreads / 32;

__host__ __device__ constexpr int num_rows(int m) { return 2 * m + 1; }
__host__ __device__ constexpr int row_blocks(int m) {
  return (num_rows(m) + kPatch - 1) / kPatch;
}
__host__ __device__ constexpr int num_patches(int m) {
  return row_blocks(m) * (row_blocks(m) + 1) / 2;
}
// A 128-column tile of every m up to kMaxMem fits the shared memory.
static_assert(sizeof(float) * row_blocks(kMaxMem) * kPatch * 128 <= kSmemBytes,
              "shared memory");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Patch p of the upper triangle, row-major: block row bi, block column
// bj >= bi, of nb block rows.
struct Patch {
  int bi;
  int bj;
};

__host__ __device__ inline Patch patch(int p, int nb) {
  int bi = 0;
  while (p >= nb - bi) {
    p -= nb - bi;
    ++bi;
  }
  return {bi, bi + p};
}

__host__ __device__ inline int patch_index(int bi, int bj, int nb) {
  return bi * nb - bi * (bi - 1) / 2 + (bj - bi);
}

// Pass 1.  Block (bx, by) handles tiles bx * tiles_per_block ... of
// 2^tile_shift columns and the patches by * warps * kPatchesPerWarp ...;
// partials[(p * 16 + e) * gridDim.x + bx] is its sum for entry e of patch p.
__global__ void __launch_bounds__(kMaxThreads, 2)
    project_partials(const float* __restrict__ s, const float* __restrict__ y,
                     const float* __restrict__ g, int m, int64_t n,
                     int tile_shift, int tiles_per_block,
                     float* __restrict__ partials) {
  extern __shared__ float tile[];  // [row_blocks * 4][tile_cols]
  const int tile_cols = 1 << tile_shift;
  const int rows = num_rows(m);
  const int nb = row_blocks(m);
  const int np = num_patches(m);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  const int first_patch = (blockIdx.y * warps + warp) * kPatchesPerWarp;
  int ra[kPatchesPerWarp];
  int rb[kPatchesPerWarp];
  float acc[kPatchesPerWarp][kPatch][kPatch];
#pragma unroll
  for (int i = 0; i < kPatchesPerWarp; ++i) {
    const int p = first_patch + i;
    const Patch pt = patch(p < np ? p : 0, nb);
    ra[i] = pt.bi * kPatch * tile_cols;
    rb[i] = pt.bj * kPatch * tile_cols;
#pragma unroll
    for (int k = 0; k < kPatch; ++k) {
#pragma unroll
      for (int l = 0; l < kPatch; ++l) acc[i][k][l] = 0.f;
    }
  }
  // The rows that pad R to a multiple of the patch stay zero throughout.
  for (int idx = rows * tile_cols + threadIdx.x;
       idx < nb * kPatch * tile_cols; idx += blockDim.x) {
    tile[idx] = 0.f;
  }

  const int64_t first = static_cast<int64_t>(blockIdx.x) * tiles_per_block;
  for (int tt = 0; tt < tiles_per_block; ++tt) {
    const int64_t col0 = (first + tt) << tile_shift;
    if (col0 >= n) break;  // the same for every thread of the block
    __syncthreads();       // the previous tile is read by everyone
    for (int idx = threadIdx.x; idx < rows * tile_cols; idx += blockDim.x) {
      const int r = idx >> tile_shift;
      const int64_t j = col0 + (idx & (tile_cols - 1));
      if (j < n) {
        const float* src = r < m       ? s + r * n + j
                           : r < 2 * m ? y + (r - m) * n + j
                                       : g + j;
        __pipeline_memcpy_async(tile + idx, src, sizeof(float));
      } else {
        tile[idx] = 0.f;
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPatchesPerWarp; ++i) {
      if (first_patch + i < np) {  // the same for every lane of the warp
        const float* a = tile + ra[i];
        const float* b = tile + rb[i];
        for (int c = lane; c < tile_cols; c += 32) {
          float av[kPatch];
          float bv[kPatch];
#pragma unroll
          for (int k = 0; k < kPatch; ++k) {
            av[k] = a[k * tile_cols + c];
            bv[k] = b[k * tile_cols + c];
          }
#pragma unroll
          for (int k = 0; k < kPatch; ++k) {
#pragma unroll
            for (int l = 0; l < kPatch; ++l) {
              acc[i][k][l] = fmaf(av[k], bv[l], acc[i][k][l]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPatchesPerWarp; ++i) {
    const int p = first_patch + i;
#pragma unroll
    for (int k = 0; k < kPatch; ++k) {
#pragma unroll
      for (int l = 0; l < kPatch; ++l) {
        const float v = warp_sum(acc[i][k][l]);
        if (lane == 0 && p < np) {
          const int64_t e =
              static_cast<int64_t>(p) * kEntries + k * kPatch + l;
          partials[e * gridDim.x + blockIdx.x] = v;
        }
      }
    }
  }
}

// Pass 2.  One warp per entry (r, q) of the square R R^T; the warps of the
// lower triangle and of g . g leave at once.  The others sum their partials
// over the pass-1 blocks (lanes stride over them, then a fixed shuffle
// tree).  out = [wg (2m) | gram (2m x 2m, row-major)].
__global__ void __launch_bounds__(kReduceThreads)
    project_reduce(const float* __restrict__ partials, int num_partials, int m,
                   float* __restrict__ out) {
  const int rows = num_rows(m);
  const int lane = threadIdx.x & 31;
  const int idx = blockIdx.x * kReduceWarps + (threadIdx.x >> 5);
  if (idx >= rows * rows) return;  // whole warps leave together
  const int r = idx / rows;
  const int q = idx - r * rows;
  if (r > q || r == 2 * m) return;
  const int p = patch_index(r / kPatch, q / kPatch, row_blocks(m));
  const int64_t e = static_cast<int64_t>(p) * kEntries +
                    (r % kPatch) * kPatch + (q % kPatch);
  const float* src = partials + e * num_partials;
  float v = 0.f;
  for (int b = lane; b < num_partials; b += 32) v += src[b];
  v = warp_sum(v);
  if (lane != 0) return;
  if (q == 2 * m) {
    out[r] = v;
  } else {
    out[2 * m + r * 2 * m + q] = v;
    out[2 * m + q * 2 * m + r] = v;
  }
}

// The launch: threads per block, patch groups (gridDim.y), the tile width
// and the pass-1 grid (one wave of blocks, each taking a run of consecutive
// tiles).
struct Plan {
  int threads;
  int groups;
  int tile_shift;
  size_t smem;
  int tiles_per_block;
  int blocks;
};

inline Plan plan(int m, int64_t n, int num_sms) {
  Plan pl;
  const int np = num_patches(m);
  const int warps = (np + kPatchesPerWarp - 1) / kPatchesPerWarp;
  pl.threads = 32 * (warps < kMaxWarps ? warps : kMaxWarps);
  const int per_block = pl.threads / 32 * kPatchesPerWarp;
  pl.groups = (np + per_block - 1) / per_block;
  const size_t row_bytes = sizeof(float) * row_blocks(m) * kPatch;
  pl.tile_shift = row_bytes * 256 <= kSmemBytes ? 8 : 7;
  pl.smem = row_bytes << pl.tile_shift;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, project_partials, pl.threads, pl.smem) != cudaSuccess ||
      per_sm < 1) {
    per_sm = 1;
  }
  const int64_t tiles = (n + (1 << pl.tile_shift) - 1) >> pl.tile_shift;
  int64_t wave = static_cast<int64_t>(per_sm) * num_sms / pl.groups;
  if (wave < 1) wave = 1;
  const int64_t tiles_per_block = (tiles + wave - 1) / wave;
  pl.tiles_per_block = static_cast<int>(tiles_per_block);
  pl.blocks = static_cast<int>((tiles + tiles_per_block - 1) / tiles_per_block);
  return pl;
}

bool valid(int m, long long n, int num_sms) {
  return m >= 1 && m <= kMaxMem && n >= 1 && num_sms >= 1;
}

}  // namespace

extern "C" {

// Floats of scratch sqn_project needs for these m and n on a card with
// num_sms SMs (one partial sum per patch entry and pass-1 block); 0 if the
// arguments are out of range.
long long sqn_project_scratch(int m, long long n, int num_sms) {
  if (!valid(m, n, num_sms)) return 0;
  return static_cast<long long>(num_patches(m)) * kEntries *
         plan(m, n, num_sms).blocks;
}

// wg = [S; Y] g and gram = [S; Y] [S; Y]^T in one pass.
//   s, y     [m, n] float32 row-major, 1 <= m <= 32;  g [n] float32
//   out      float32, 2m + 4m*m: wg (2m) | gram (2m x 2m)
//   scratch  float32, sqn_project_scratch(m, n, num_sms) floats
//   num_sms  SMs of the card the stream belongs to (sizes the grid)
// Returns cudaGetLastError() after the launches (0 on success).
int sqn_project(const float* s, const float* y, const float* g, float* out,
                float* scratch, int m, long long n, int num_sms,
                void* stream) {
  if (!valid(m, n, num_sms)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan pl = plan(m, n, num_sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  project_partials<<<dim3(pl.blocks, pl.groups), pl.threads, pl.smem, st>>>(
      s, y, g, m, n, pl.tile_shift, pl.tiles_per_block, scratch);
  const int entries = num_rows(m) * num_rows(m);
  project_reduce<<<(entries + kReduceWarps - 1) / kReduceWarps, kReduceThreads,
                   0, st>>>(scratch, pl.blocks, m, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
