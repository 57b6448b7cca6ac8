// adaQN projection on Hopper: one pass over the pair memory gives
//
//     wg  = W g          [2m],   W = [S; Y]  ([2m, n])
//     ydg = (Y o D) g    [m]
//     ydy = (Y o D) Y^T  [m, m],  D = diag(d)
//
// and Y o D is never stored.  Replaces the Pallas TPU kernel
// stochqn_tpu/ops/pallas/two_loop_kernel.py::project_adaqn (pallas_call at
// :390).  Every input is float32 and every sum is accumulated in float32 (no
// TF32 tensor-core products: they would miss the tolerance the kernel is held
// to).  d may have either sign (with h0_exact_reference it is the rescaled
// gradient).
//
// What bounds it on the card: bytes, if loading and summing overlap and the
// sums stay off shared memory's critical path.  It reads (2m + 2) n floats,
// 25.7 MB at the flagship shape (m = 10, n = 292,083), and needs
// 3m + m(m + 1)/2 = 85 sums per column there with ydy's symmetry used, about
// 3 FLOP per byte, under the H100's ~20 FLOP/byte float32 balance point.
// One sum per thread reads two or three shared-memory words per
// multiply-add, which alone costs more than the bytes do; and a block that
// waits for a tile before it sums it never loads and sums at once.
//
// What the design does about it.  The TPU kernel walks its grid in order and
// accumulates all three outputs in VMEM across grid steps; on Hopper blocks
// run in parallel and in no order, so the work is two launches:
//
//   1. partials: one wave of blocks, each taking a run of consecutive tiles
//      of columns of S, Y, g and d.  The tiles go through a ring of kStages
//      buffers in dynamic shared memory, filled with cp.async: the copies of
//      the next tiles are in flight while a tile is summed.  The sums are
//      cut into units, one or two per warp: ydg and ydy are the upper
//      triangle of (R o d) R^T with R = [Y; g], cut into 4 x 4 patches, and
//      wg is cut into groups of 8 rows of W times g.  A lane reads 4
//      neighbouring columns of a row in one 16-byte load, forms its values
//      of R o d once per column and keeps the 16 sums of a patch in
//      registers over its columns of the tile: 9 loads of 16 bytes per 64
//      multiply-adds, no bank conflicts.  Where m is so large that a block's
//      warps cannot hold all the units, gridDim.y splits them and each y
//      stages the tiles again.  At the end every warp sums its lanes with a
//      fixed shuffle tree into partials[unit, entry, block].
//   2. reduce: one warp per output sums its partials over the blocks in a
//      fixed order and writes wg, ydg and both halves of ydy.  It is launched
//      as a programmatic dependent of the partials: its blocks are placed
//      while the partials still run and wait in
//      cudaGridDependencySynchronize() for their end, so the second launch's
//      latency is not added to the first one's time.
//
// Rows are not 16-byte aligned in device memory: with an odd n each row of S
// and Y has its own phase.  The copies are 4 bytes each, one warp per row
// and the lanes on neighbouring columns (no divide, the offsets immediate),
// so that every staged row starts on a 16-byte boundary and the sums can
// read 16 bytes at a time.  Copies of 16 bytes into rows that keep their
// phase were measured: they gained nothing over 4-byte ones, and would take
// the 16-byte reads away.  The tile that holds the end of the rows is
// staged with zeros past n.
//
// No atomics and a fixed order of every sum, so every run gives the same
// bits.  S, Y, d and g are never padded or copied.
//
// Plain C interface, loaded with ctypes.  Both launches are on the caller's
// stream; the function returns the first error of sizing the grid and of
// the two launches.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "projection.cuh"

namespace {

using projection::kMaxMem;
using projection::Patch;
using projection::patch;

constexpr int kStages = 3;      // buffers of the ring
constexpr int kPatch = 4;       // a lane's register patch: 4 x 4 sums
constexpr int kEntries = kPatch * kPatch;
constexpr int kWgRows = 8;      // rows of W in one unit of wg
constexpr int kMaxWarps = 16;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kMaxRows = 2 * kMaxMem + 2;  // staged rows: S, Y, g, d
constexpr int kLane = 4;        // columns a lane reads at once: 16 bytes
constexpr size_t kRingBytes = 110 * 1024;  // the ring of a block, at most
constexpr int kReduceThreads = 256;
constexpr int kReduceWarps = kReduceThreads / 32;

// R = [Y; g] has m + 1 rows, in row blocks of kPatch.
__host__ __device__ constexpr int row_blocks(int m) {
  return (m + 1 + kPatch - 1) / kPatch;
}
__host__ __device__ constexpr int num_patches(int m) {
  return row_blocks(m) * (row_blocks(m) + 1) / 2;
}
__host__ __device__ constexpr int num_units(int m) {
  return num_patches(m) + (2 * m + kWgRows - 1) / kWgRows;
}
__host__ __device__ constexpr size_t stage_bytes(int m, int tile) {
  return sizeof(float) * (2 * m + 2) * tile;
}
// A ring of 128-column tiles of every m up to kMaxMem fits.
static_assert(kStages * stage_bytes(kMaxMem, 128) <= kRingBytes,
              "shared memory");
// The largest m whose units one block holds with one unit per warp.
constexpr int max_mem_one_unit() {
  int m = 1;
  while (m < kMaxMem && num_units(m + 1) <= kMaxWarps) ++m;
  return m;
}
// Every such m takes a ring of 256-column tiles: one unit per warp needs no
// kernel of 128-column tiles.
static_assert(kStages * stage_bytes(max_mem_one_unit(), 256) <= kRingBytes,
              "one unit per warp goes with tiles of 256");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// The index of the patch at block row bi, block column bj >= bi, of nb block
// rows (projection::patch the other way round).
__host__ __device__ inline int patch_index(int bi, int bj, int nb) {
  return bi * nb - bi * (bi - 1) / 2 + (bj - bi);
}

// Pass 1.  Block (bx, by) handles tiles bx * tiles_per_block ... of TILE
// columns and the units by * warps * UPW ...;
// partials[(unit * 16 + e) * gridDim.x + bx] is its sum for entry e of the
// unit (e < 16 for a patch, e < 8 for a unit of wg).
template <int UPW, int TILE>
__global__ void __launch_bounds__(kMaxThreads)
    adaqn_partials(const float* __restrict__ s, const float* __restrict__ y,
                   const float* __restrict__ d, const float* __restrict__ g,
                   int m, int64_t n, int tiles_per_block,
                   float* __restrict__ partials) {
  // [kStages][rows][TILE]; staged rows: S (0 .. m-1), Y (m .. 2m-1), g (2m),
  // d (2m+1)
  extern __shared__ __align__(16) float ring[];
  __shared__ const float* row_src[kMaxRows];
  constexpr int kSteps = TILE / (32 * kLane);  // 16-byte reads of a lane a row
  const int rows = 2 * m + 2;
  const int stage_floats = rows * TILE;
  const int nb = row_blocks(m);
  const int np = num_patches(m);
  const int nu = num_units(m);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;

  // The reduce may be placed on the card from now on; it waits there until
  // this grid has ended and its partials are in memory.
  cudaTriggerProgrammaticLaunchCompletion();

  for (int r = tid; r < rows; r += blockDim.x) {
    row_src[r] = r < m       ? s + r * n
                 : r < 2 * m ? y + (r - m) * n
                 : r == 2 * m ? g
                              : d;
  }

  const int first_unit = (blockIdx.y * warps + warp) * UPW;
  float acc[UPW][kEntries];
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
#pragma unroll
    for (int e = 0; e < kEntries; ++e) acc[i][e] = 0.f;
  }

  const int64_t tiles = (n + TILE - 1) / TILE;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * tiles_per_block;
  const int my_tiles = first >= tiles ? 0
                       : tiles - first < tiles_per_block
                           ? static_cast<int>(tiles - first)
                           : tiles_per_block;
  __syncthreads();  // row_src is written

  // Copies tile t of this block into its buffer of the ring: one warp per
  // row, the lanes on neighbouring columns.
  auto stage = [&](int t) {
    float* buf = ring + (t % kStages) * stage_floats;
    const int64_t col0 = (first + t) * TILE;
    const bool whole = col0 + TILE <= n;
    for (int r = warp; r < rows; r += warps) {
      const float* src = row_src[r] + col0 + lane;
      float* dst = buf + r * TILE + lane;
      if (whole) {
#pragma unroll
        for (int c = 0; c < TILE; c += 32) {
          __pipeline_memcpy_async(dst + c, src + c, sizeof(float));
        }
      } else {
        // the tile that holds the end of the rows: zeros past n
#pragma unroll
        for (int c = 0; c < TILE; c += 32) {
          if (col0 + lane + c < n) {
            __pipeline_memcpy_async(dst + c, src + c, sizeof(float));
          } else {
            dst[c] = 0.f;
          }
        }
      }
    }
  };

  for (int t = 0; t < kStages - 1; ++t) {
    if (t < my_tiles) stage(t);
    __pipeline_commit();
  }
  for (int t = 0; t < my_tiles; ++t) {
    __pipeline_wait_prior(kStages - 2);  // this thread's copies of tile t
    __syncthreads();  // everyone's; and tile t - 1 is summed by everyone
    if (t + kStages - 1 < my_tiles) stage(t + kStages - 1);
    __pipeline_commit();

    // lane l reads the columns 4 l ... 4 l + 3 (+ 128 per step) of a row
    const float4* buf = reinterpret_cast<const float4*>(
                            ring + (t % kStages) * stage_floats) + lane;
    constexpr int kRow = TILE / kLane;  // float4s of a staged row
#pragma unroll
    for (int i = 0; i < UPW; ++i) {
      const int unit = first_unit + i;
      if (unit < np) {  // the same for every lane of the warp
        // a patch of (R o d) R^T: row i of R is staged row m + i (g is
        // row m of R and staged row 2m); rows past g repeat it, and their
        // sums are never read
        const Patch pt = patch(unit, nb);
        const float4* a[kPatch];
        const float4* b[kPatch];
#pragma unroll
        for (int k = 0; k < kPatch; ++k) {
          const int ia = pt.bi * kPatch + k;
          const int ib = pt.bj * kPatch + k;
          a[k] = buf + (m + (ia < m ? ia : m)) * kRow;
          b[k] = buf + (m + (ib < m ? ib : m)) * kRow;
        }
        const float4* dd = buf + (2 * m + 1) * kRow;
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const float4 dv = dd[32 * j];
          float4 av[kPatch];
#pragma unroll
          for (int k = 0; k < kPatch; ++k) {
            av[k] = a[k][32 * j];
            av[k].x *= dv.x;
            av[k].y *= dv.y;
            av[k].z *= dv.z;
            av[k].w *= dv.w;
          }
#pragma unroll
          for (int l = 0; l < kPatch; ++l) {
            const float4 bv = b[l][32 * j];
#pragma unroll
            for (int k = 0; k < kPatch; ++k) {
              float t4 = acc[i][k * kPatch + l];
              t4 = fmaf(av[k].x, bv.x, t4);
              t4 = fmaf(av[k].y, bv.y, t4);
              t4 = fmaf(av[k].z, bv.z, t4);
              t4 = fmaf(av[k].w, bv.w, t4);
              acc[i][k * kPatch + l] = t4;
            }
          }
        }
      } else if (unit < nu) {
        // 8 rows of W = [S; Y] times g; rows past the last repeat it
        const int r0 = (unit - np) * kWgRows;
        const float4* gg = buf + 2 * m * kRow;
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const float4 gv = gg[32 * j];
#pragma unroll
          for (int k = 0; k < kWgRows; ++k) {
            const int r = r0 + k < 2 * m ? r0 + k : 2 * m - 1;
            const float4 wv = buf[r * kRow + 32 * j];
            float t4 = acc[i][k];
            t4 = fmaf(wv.x, gv.x, t4);
            t4 = fmaf(wv.y, gv.y, t4);
            t4 = fmaf(wv.z, gv.z, t4);
            t4 = fmaf(wv.w, gv.w, t4);
            acc[i][k] = t4;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int unit = first_unit + i;
#pragma unroll
    for (int e = 0; e < kEntries; ++e) {
      const float v = warp_sum(acc[i][e]);
      if (lane == 0 && unit < nu) {
        partials[(static_cast<int64_t>(unit) * kEntries + e) * gridDim.x +
                 blockIdx.x] = v;
      }
    }
  }
}

// Pass 2.  One warp per entry (i, j) of the m x (m + 1) product
// (Y o d) [Y; g]^T, then one per entry of wg; the warps of ydy's lower
// triangle leave at once.  The others sum their partials over the pass-1
// blocks (lanes stride over them, then a fixed shuffle tree).
// out = [wg (2m) | ydg (m) | ydy (m * m, row-major)].
//
// partials is written by pass 1, which may still run when this grid starts:
// no __restrict__, nothing of it is read before the dependency is met, and
// the reads bypass L1.
__global__ void __launch_bounds__(kReduceThreads)
    adaqn_reduce(const float* partials, int num_partials, int m,
                 float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int idx = blockIdx.x * kReduceWarps + (threadIdx.x >> 5);
  const int square = m * (m + 1);
  if (idx >= square + 2 * m) return;  // whole warps leave together
  int i = 0, j = 0;
  int64_t e;
  if (idx < square) {
    i = idx / (m + 1);
    j = idx - i * (m + 1);
    if (j < i) return;
    const int p = patch_index(i / kPatch, j / kPatch, row_blocks(m));
    e = static_cast<int64_t>(p) * kEntries + (i % kPatch) * kPatch +
        (j % kPatch);
  } else {
    const int k = idx - square;
    e = static_cast<int64_t>(num_patches(m) + k / kWgRows) * kEntries +
        k % kWgRows;
  }
  const float* src = partials + e * num_partials;
  cudaGridDependencySynchronize();
  float v = 0.f;
  for (int b = lane; b < num_partials; b += 32) v += __ldcg(src + b);
  v = warp_sum(v);
  if (lane != 0) return;
  if (idx >= square) {
    out[idx - square] = v;
  } else if (j == m) {
    out[2 * m + i] = v;
  } else {
    out[3 * m + i * m + j] = v;
    out[3 * m + j * m + i] = v;
  }
}

// The launch: units per warp, threads per block, unit groups (gridDim.y),
// the tile width, the ring's bytes and the pass-1 grid (one wave of blocks,
// each taking a run of consecutive tiles); err is the error of asking the
// runtime what the card holds, and the grid is empty where it is set.
struct Plan {
  cudaError_t err;
  int upw;
  int threads;
  int groups;
  int tile;
  size_t smem;
  int tiles_per_block;
  int blocks;
};

using Partials = void (*)(const float*, const float*, const float*,
                          const float*, int, int64_t, int, float*);

// One unit per warp goes with 256-column tiles (the static_assert above).
Partials kernel_of(int upw, int tile) {
  if (upw == 1) return adaqn_partials<1, 256>;
  return tile == 256 ? adaqn_partials<2, 256> : adaqn_partials<2, 128>;
}

// Dynamic shared memory over 48 KB has to be asked for.
cudaError_t opt_in() {
  for (Partials kernel : {kernel_of(1, 256), kernel_of(2, 256),
                          kernel_of(2, 128)}) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kRingBytes));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

inline Plan plan(int m, int64_t n, int num_sms) {
  static projection::BlocksPerSm blocks_per_sm;
  Plan pl = {};
  const int nu = num_units(m);
  pl.upw = nu <= kMaxWarps ? 1 : 2;
  const int warps = (nu + pl.upw - 1) / pl.upw;
  pl.threads = 32 * (warps < kMaxWarps ? warps : kMaxWarps);
  const int per_block = pl.threads / 32 * pl.upw;
  pl.groups = (nu + per_block - 1) / per_block;
  pl.tile = kStages * stage_bytes(m, 256) <= kRingBytes ? 256 : 128;
  pl.smem = kStages * stage_bytes(m, pl.tile);
  const int64_t tiles = (n + pl.tile - 1) / pl.tile;
  int per_sm = 0;
  pl.err = blocks_per_sm.ask(kernel_of(pl.upw, pl.tile), pl.threads, pl.smem,
                             m, opt_in, &per_sm);
  if (pl.err != cudaSuccess) return pl;
  int64_t wave = static_cast<int64_t>(per_sm) * num_sms / pl.groups;
  if (wave < 1) wave = 1;
  const int64_t tiles_per_block = (tiles + wave - 1) / wave;
  pl.tiles_per_block = static_cast<int>(tiles_per_block);
  pl.blocks = static_cast<int>((tiles + tiles_per_block - 1) / tiles_per_block);
  return pl;
}

}  // namespace

extern "C" {

// Floats of scratch adaqn_project needs for these m and n on a card with
// num_sms SMs (one partial sum per unit entry and pass-1 block); 0 if the
// arguments are out of range or the card cannot launch the kernel.
long long adaqn_project_scratch(int m, long long n, int num_sms) {
  if (!projection::valid(m, n, num_sms)) return 0;
  return static_cast<long long>(num_units(m)) * kEntries *
         plan(m, n, num_sms).blocks;
}

// wg = [S; Y] g, ydg = (Y o d) g, ydy = (Y o d) Y^T in one pass.
//   s, y     [m, n] float32 row-major, 1 <= m <= 32;  d, g [n] float32
//   out      float32, 3m + m*m: wg (2m) | ydg (m) | ydy (m x m)
//   scratch  float32, adaqn_project_scratch(m, n, num_sms) floats
//   num_sms  SMs of the card the stream belongs to (sizes the grid)
// Returns the first error of sizing the grid and of the launches (0 on
// success).
int adaqn_project(const float* s, const float* y, const float* d,
                  const float* g, float* out, float* scratch, int m,
                  long long n, int num_sms, void* stream) {
  if (!projection::valid(m, n, num_sms)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan pl = plan(m, n, num_sms);
  if (pl.err != cudaSuccess) return static_cast<int>(pl.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(pl.blocks, pl.groups);
  kernel_of(pl.upw, pl.tile)<<<grid, pl.threads, pl.smem, st>>>(
      s, y, d, g, m, n, pl.tiles_per_block, scratch);
  const int outputs = m * (m + 1) + 2 * m;
  const cudaError_t err = projection::launch_dependent(
      adaqn_reduce, dim3((outputs + kReduceWarps - 1) / kReduceWarps),
      kReduceThreads, 0, st, scratch, pl.blocks, m, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
