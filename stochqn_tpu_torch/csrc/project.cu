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
// What bounds it on the card: bytes, but only just.  It reads (2m + 1) n
// floats once and needs 2m + m(2m + 1) sums per column with the Gram's
// symmetry used, 230 at m = 10: well under the card's float32 rate.  But
// every multiply-add takes its two factors from shared memory, the sums grow
// with m squared where the bytes grow with m, and a warp that waits for a
// tile, asks for the next one and then sums does the three in turn, not at
// once.  So the design has to keep loading while it sums, to read few
// shared-memory words per multiply-add, and to leave out the sums that the
// symmetry makes idle.
//
// What the design does about it.  The TPU kernel walks its grid in order and
// accumulates in VMEM across grid steps; on Hopper blocks run in parallel
// and in no order, so the work is two launches:
//
//   1. partials: one wave of blocks (one per SM at the flagship shape), each
//      taking a run of consecutive tiles of 256 columns of S, Y and g.  The
//      tiles go through a ring of kStages buffers in dynamic shared memory,
//      filled with cp.async.  The rows of W are cut into blocks of 8 and the
//      upper triangle of W W^T into 8 x 8 patches, one per warp: a lane
//      reads 4 neighbouring columns of a row in one 16-byte load and keeps
//      the 64 sums of its patch in registers over its columns of the tile,
//      16 loads per 256 multiply-adds and no bank conflicts.  A patch on the
//      diagonal reads its 8 rows once and sums only its upper triangle.
//      Where W leaves room in its last row block (2m not a multiple of 8) g
//      rides there as one more row and wg falls out of the patches of the
//      last block column; where it does not, one more warp sums the rows of
//      W times g.  The staged rows are padded to whole row blocks with rows
//      of zeros written once.
//      Where the warps that sum leave room (up to 13 of 16), 3 or 4 more
//      warps do nothing but stage: they keep kStages - 1 tiles in flight and
//      meet the summing warps at two named barriers per buffer ("full" when
//      a tile has landed, "empty" when every warp has summed it), so that no
//      summing warp waits for another or stalls on a copy it issued.  Where
//      there is no room (m = 17 ... 20: 15 or 16 units), every warp stages
//      and sums and the block meets at every tile.  Where m is so large that
//      16 warps cannot hold every unit (m > 20), gridDim.y splits the units
//      and each y stages the tiles again; the groups run at once and share
//      the L2.  At the end every warp sums its lanes with a butterfly of 31
//      shuffles per 32 sums, in a fixed order, into
//      partials[block, unit, entry]: one coalesced store.
//   2. reduce: one block per unit sums its 64 entries over the pass-1 blocks
//      in a fixed order and writes wg and both halves of gram.
//
// Both are launched as programmatic dependents of what is before them on
// the stream: their blocks are placed while that work still runs, do what
// needs no device memory, and wait in cudaGridDependencySynchronize() for
// its end, so that a launch's latency is not added to the time of the work
// before it.
//
// Rows are not 16-byte aligned in device memory: with an odd n each row of S
// and Y has its own phase.  The copies are 4 bytes each, one warp per row
// and the lanes on neighbouring columns, so that every staged row starts on
// a 16-byte boundary and the sums can read whole vectors.  The tile that
// holds the end of the rows is staged with zeros past n.
//
// No atomics and a fixed order of every sum, so every run gives the same
// bits and the Gram is exactly symmetric.  S, Y and g are never padded or
// copied.
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
constexpr int kTile = 256;      // columns of a tile
constexpr int kPatch = 8;       // a lane's register patch: 8 x 8 sums
constexpr int kEntries = kPatch * kPatch;
// 16 warps of 128 registers a thread are the SM's register file.
constexpr int kMaxWarps = 16;
// Warps that only stage, where the warps that sum leave room for them.
constexpr int kStagers = 4;
constexpr int kMinStagers = 3;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kMaxRows = 2 * kMaxMem + 1;  // staged rows: S, Y, g
using Vec = float4;             // what a lane reads at once: 16 bytes
constexpr int kLane = sizeof(Vec) / sizeof(float);
constexpr int kRow = kTile / kLane;             // Vecs of a staged row
constexpr int kSteps = kTile / (32 * kLane);    // reads of a lane a row
constexpr int kReduceGroups = 16;               // of kEntries threads each
constexpr int kReduceThreads = kReduceGroups * kEntries;

// W = [S; Y] has 2m rows, in row blocks of kPatch.
__host__ __device__ constexpr int row_blocks(int m) {
  return (2 * m + kPatch - 1) / kPatch;
}
__host__ __device__ constexpr int num_patches(int m) {
  return row_blocks(m) * (row_blocks(m) + 1) / 2;
}
// Whether g rides in the last row block of W as one more row; where W fills
// its row blocks, wg is a unit of its own.
__host__ __device__ constexpr bool g_rides(int m) {
  return 2 * m % kPatch != 0;
}
__host__ __device__ constexpr int num_units(int m) {
  return num_patches(m) + (g_rides(m) ? 0 : 1);
}
// Rows of a staged tile: W padded to whole row blocks, and g.
__host__ __device__ constexpr int staged_rows(int m) {
  return row_blocks(m) * kPatch > 2 * m ? row_blocks(m) * kPatch : 2 * m + 1;
}
__host__ __device__ constexpr size_t ring_bytes(int m) {
  return sizeof(float) * kStages * staged_rows(m) * kTile;
}
// The ring of every m up to kMaxMem fits the shared memory of an SM, and a
// unit of wg holds every row of W.
static_assert(ring_bytes(kMaxMem) <= 226 * 1024, "shared memory");
static_assert(2 * kMaxMem <= kEntries, "one unit of wg");

// c + a . b over the columns of a Vec, left to right.
__device__ __forceinline__ float dot_add(const Vec& a, const Vec& b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

// Named barriers of a block (0 is __syncthreads): one pair per buffer of the
// ring.  A tile is "full" when its copies have landed and "empty" when every
// warp has summed it.  `threads` is everyone who arrives or waits.
constexpr int kFull = 1;
constexpr int kEmpty = kFull + kStages;

__device__ __forceinline__ void barrier_wait(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// One exchange of the butterfly below: the lanes whose bit OFF is set keep
// the upper OFF of 2 OFF values and send the lower ones, the other lanes the
// other way round.
template <int OFF>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int e = 0; e < OFF; ++e) {
    const float send = upper ? v[e] : v[e + OFF];
    const float keep = upper ? v[e + OFF] : v[e];
    v[e] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// The sums of v[e] over the warp's lanes, for all 32 e at once: lane e
// returns the sum of v[e].  A butterfly that halves the values a lane holds
// at every exchange: 31 shuffles where 32 single sums take 160, in a fixed
// order.
__device__ __forceinline__ float warp_sums(float (&v)[32], int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// Pass 1.  Block (bx, by) handles tiles bx * tiles_per_block ... and as many
// units as it has summing warps, from by times that number on.
// partials[(bx * units + u) * 64 + e] is the sum for entry e of unit u: row
// e / 8 of a patch's 8 times row e % 8 of the 8 it is held against, or row e
// of W times g.
__global__ void __launch_bounds__(kMaxThreads)
    project_partials(const float* __restrict__ s, const float* __restrict__ y,
                     const float* __restrict__ g, int m, int64_t n,
                     int tiles_per_block, int stagers,
                     float* __restrict__ partials) {
  // [kStages][staged_rows][kTile]; staged rows: S (0 .. m-1), Y (m .. 2m-1),
  // g (2m), then zeros up to a whole row block
  extern __shared__ __align__(16) float ring[];
  __shared__ const float* row_src[kMaxRows];
  const int rows = 2 * m + 1;
  const int stage_floats = staged_rows(m) * kTile;
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
    row_src[r] = r < m ? s + r * n : r < 2 * m ? y + (r - m) * n : g;
  }
  // the rows that pad W and g to whole row blocks stay zero throughout
  for (int st = 0; st < kStages; ++st) {
    for (int idx = rows * kTile + tid; idx < stage_floats; idx += blockDim.x) {
      ring[st * stage_floats + idx] = 0.f;
    }
  }

  // the last `stagers` warps only stage (and no other does); where there is
  // none, every warp stages and sums
  const int summers = warps - stagers;
  const bool sums = warp < summers;
  const int stage_first = stagers == 0 ? warp : sums ? rows : warp - summers;
  const int stage_stride = stagers == 0 ? warps : stagers;
  const int u = sums ? blockIdx.y * summers + warp : nu;
  // Vecs from a staged tile's start to the patch's 8 rows and to the 8 it
  // is held against
  const Patch pt = patch(u < np ? u : 0, nb);
  const int ra = pt.bi * kPatch * kRow;
  const int rb = pt.bj * kPatch * kRow;
  float acc[kEntries];
#pragma unroll
  for (int e = 0; e < kEntries; ++e) acc[e] = 0.f;

  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * tiles_per_block;
  const int my_tiles = first >= tiles ? 0
                       : tiles - first < tiles_per_block
                           ? static_cast<int>(tiles - first)
                           : tiles_per_block;
  __syncthreads();  // row_src is written
  // This grid is itself launched as a programmatic dependent of the work
  // before it on the stream: up to here it has touched no device memory,
  // from here on that work has ended and its results are in memory.
  cudaGridDependencySynchronize();

  // Copies tile t of this block into its buffer of the ring: one staging
  // warp per row, the lanes on neighbouring columns.
  auto stage = [&](int t) {
    float* buf = ring + (t % kStages) * stage_floats;
    const int64_t col0 = (first + t) * kTile;
    const bool whole = col0 + kTile <= n;
    for (int r = stage_first; r < rows; r += stage_stride) {
      const float* src = row_src[r] + col0 + lane;
      float* dst = buf + r * kTile + lane;
      if (whole) {
#pragma unroll
        for (int c = 0; c < kTile; c += 32) {
          __pipeline_memcpy_async(dst + c, src + c, sizeof(float));
        }
      } else {
        // the tile that holds the end of the rows: zeros past n
#pragma unroll
        for (int c = 0; c < kTile; c += 32) {
          if (col0 + lane + c < n) {
            __pipeline_memcpy_async(dst + c, src + c, sizeof(float));
          } else {
            dst[c] = 0.f;
          }
        }
      }
    }
  };

  // Adds tile t of this block to this warp's sums.
  auto sum = [&](int t) {
    // lane l reads the columns 4 l ... 4 l + 3 (+ 128 per step) of a row
    const Vec* buf = reinterpret_cast<const Vec*>(
                            ring + (t % kStages) * stage_floats) + lane;
    if (u < np && ra == rb) {  // the same for every lane of the warp
      // on the diagonal the patch's 8 rows are also the 8 it is held
      // against, and only the upper triangle is read
      const Vec* a = buf + ra;
#pragma unroll 1
      for (int j = 0; j < kSteps; ++j) {
        Vec av[kPatch];
#pragma unroll
        for (int k = 0; k < kPatch; ++k) av[k] = a[k * kRow + 32 * j];
#pragma unroll
        for (int l = 0; l < kPatch; ++l) {
#pragma unroll
          for (int k = 0; k <= l; ++k) {
            acc[k * kPatch + l] = dot_add(av[k], av[l], acc[k * kPatch + l]);
          }
        }
      }
    } else if (u < np) {
      const Vec* a = buf + ra;
      const Vec* b = buf + rb;
#pragma unroll 1
      for (int j = 0; j < kSteps; ++j) {
        Vec av[kPatch];
#pragma unroll
        for (int k = 0; k < kPatch; ++k) av[k] = a[k * kRow + 32 * j];
#pragma unroll
        for (int l = 0; l < kPatch; ++l) {
          const Vec bv = b[l * kRow + 32 * j];
#pragma unroll
          for (int k = 0; k < kPatch; ++k) {
            acc[k * kPatch + l] = dot_add(av[k], bv, acc[k * kPatch + l]);
          }
        }
      }
    } else if (u < nu) {
      // the rows of W times g, 8 rows at a time (W fills its row blocks)
      const Vec* gg = buf + 2 * m * kRow;
#pragma unroll 1
      for (int j = 0; j < kSteps; ++j) {
        const Vec gv = gg[32 * j];
#pragma unroll
        for (int c = 0; c < kEntries / kPatch; ++c) {
          if (c * kPatch < 2 * m) {
#pragma unroll
            for (int k = 0; k < kPatch; ++k) {
              const Vec wv = buf[(c * kPatch + k) * kRow + 32 * j];
              acc[c * kPatch + k] = dot_add(wv, gv, acc[c * kPatch + k]);
            }
          }
        }
      }
    }
  };

  if (stagers == 0) {
    // every warp stages and sums: tile t + 2 is asked for, then tile t is
    // summed, and the block meets at every tile
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < my_tiles) stage(t);
      __pipeline_commit();
    }
    for (int t = 0; t < my_tiles; ++t) {
      __pipeline_wait_prior(kStages - 2);  // this thread's copies of tile t
      __syncthreads();  // everyone's; and tile t - 1 is summed by everyone
      if (t + kStages - 1 < my_tiles) stage(t + kStages - 1);
      __pipeline_commit();
      sum(t);
    }
  } else if (!sums) {
    // a staging warp: keeps kStages - 1 tiles in flight, says when a tile
    // is full, and refills a buffer once every summing warp has left it
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < my_tiles) stage(t);
      __pipeline_commit();
    }
    for (int t = 0; t < my_tiles; ++t) {
      __pipeline_wait_prior(kStages - 2);  // this thread's copies of tile t
      __threadfence_block();
      barrier_arrive(kFull + t % kStages, blockDim.x);
      const int next = t + kStages - 1;
      if (next < my_tiles) {
        if (next >= kStages) barrier_wait(kEmpty + next % kStages, blockDim.x);
        stage(next);
      }
      __pipeline_commit();
    }
  } else {
    // a summing warp: waits for no other summing warp, only for its tile
    for (int t = 0; t < my_tiles; ++t) {
      barrier_wait(kFull + t % kStages, blockDim.x);
      sum(t);
      if (t + kStages < my_tiles) {
        barrier_arrive(kEmpty + t % kStages, blockDim.x);
      }
    }
  }

  float* out = partials +
               (static_cast<int64_t>(blockIdx.x) * nu + u) * kEntries + lane;
#pragma unroll
  for (int h = 0; h < kEntries / 32; ++h) {
    float v[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) v[e] = acc[32 * h + e];
    const float total = warp_sums(v, lane);
    if (u < nu) out[32 * h] = total;
  }
}

// Pass 2.  One block per unit: thread (group, e) sums entry e of the unit
// over every 16th partial, then the first 64 threads add the 16 groups in a
// fixed order and write wg and both halves of gram.
// out = [wg (2m) | gram (2m x 2m, row-major)].
//
// partials is written by pass 1, which may still run when this grid starts:
// no __restrict__, nothing of it is read before the dependency is met, and
// the reads bypass L1.
__global__ void __launch_bounds__(kReduceThreads)
    project_reduce(const float* partials, int num_partials, int m,
                   float* __restrict__ out) {
  __shared__ float part[kReduceGroups][kEntries];
  const int u = blockIdx.x;
  const int nu = gridDim.x;
  const int e = threadIdx.x % kEntries;
  const int group = threadIdx.x / kEntries;
  const float* src = partials + static_cast<int64_t>(u) * kEntries + e;
  const int64_t stride = static_cast<int64_t>(nu) * kEntries;
  cudaGridDependencySynchronize();
  float v = 0.f;
#pragma unroll 8
  for (int p = group; p < num_partials; p += kReduceGroups) {
    v += __ldcg(src + p * stride);
  }
  part[group][e] = v;
  __syncthreads();
  if (group != 0) return;
  v = 0.f;
#pragma unroll
  for (int k = 0; k < kReduceGroups; ++k) v += part[k][e];
  if (u >= num_patches(m)) {  // the unit of wg
    if (e < 2 * m) out[e] = v;
    return;
  }
  const Patch pt = patch(u, row_blocks(m));
  const int r = pt.bi * kPatch + e / kPatch;
  const int q = pt.bj * kPatch + e % kPatch;
  if (r > q || r >= 2 * m || q > 2 * m) return;
  if (q == 2 * m) {  // g rides as row 2m
    out[r] = v;
  } else {
    out[2 * m + r * 2 * m + q] = v;
    out[2 * m + q * 2 * m + r] = v;
  }
}

// The launch: unit groups (gridDim.y), the warps that only stage, threads
// per block, the ring's bytes and the pass-1 grid (one wave of blocks, each
// taking a run of consecutive tiles); err is the error of asking the runtime
// what the card holds, and the grid is empty where it is set.
struct Plan {
  cudaError_t err;
  int groups;
  int stagers;
  int threads;
  size_t smem;
  int tiles_per_block;
  int blocks;
};

// Dynamic shared memory over 48 KB has to be asked for.
cudaError_t opt_in() {
  return cudaFuncSetAttribute(project_partials,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(ring_bytes(kMaxMem)));
}

inline Plan plan(int m, int64_t n, int num_sms) {
  static projection::BlocksPerSm blocks_per_sm;
  Plan pl = {};
  const int nu = num_units(m);
  pl.groups = (nu + kMaxWarps - 1) / kMaxWarps;
  const int summers = (nu + pl.groups - 1) / pl.groups;  // one unit a warp
  // fewer than kMinStagers warps to spare cannot keep the ring filled: then
  // every warp stages and sums
  const int spare = kMaxWarps - summers;
  pl.stagers = spare < kMinStagers ? 0 : spare < kStagers ? spare : kStagers;
  pl.threads = 32 * (summers + pl.stagers);
  pl.smem = ring_bytes(m);
  int per_sm = 0;
  pl.err = blocks_per_sm.ask(project_partials, pl.threads, pl.smem, m, opt_in,
                             &per_sm);
  if (pl.err != cudaSuccess) return pl;
  const int64_t tiles = (n + kTile - 1) / kTile;
  int64_t wave = static_cast<int64_t>(per_sm) * num_sms / pl.groups;
  if (wave < 1) wave = 1;
  const int64_t tiles_per_block = (tiles + wave - 1) / wave;
  pl.tiles_per_block = static_cast<int>(tiles_per_block);
  pl.blocks = static_cast<int>((tiles + tiles_per_block - 1) / tiles_per_block);
  return pl;
}

}  // namespace

extern "C" {

// Floats of scratch sqn_project needs for these m and n on a card with
// num_sms SMs (one partial sum per unit entry and pass-1 block); 0 if the
// arguments are out of range or the card cannot launch the kernel.
long long sqn_project_scratch(int m, long long n, int num_sms) {
  if (!projection::valid(m, n, num_sms)) return 0;
  return static_cast<long long>(num_units(m)) * kEntries *
         plan(m, n, num_sms).blocks;
}

// wg = [S; Y] g and gram = [S; Y] [S; Y]^T in one pass.
//   s, y     [m, n] float32 row-major, 1 <= m <= 32;  g [n] float32
//   out      float32, 2m + 4m*m: wg (2m) | gram (2m x 2m)
//   scratch  float32, sqn_project_scratch(m, n, num_sms) floats
//   num_sms  SMs of the card the stream belongs to (sizes the grid)
// Returns the first error of sizing the grid and of the launches (0 on
// success).
int sqn_project(const float* s, const float* y, const float* g, float* out,
                float* scratch, int m, long long n, int num_sms,
                void* stream) {
  if (!projection::valid(m, n, num_sms)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan pl = plan(m, n, num_sms);
  if (pl.err != cudaSuccess) return static_cast<int>(pl.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = projection::launch_dependent(
      project_partials, dim3(pl.blocks, pl.groups), pl.threads, pl.smem, st,
      s, y, g, m, n, pl.tiles_per_block, pl.stagers, scratch);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = projection::launch_dependent(project_reduce, dim3(num_units(m)),
                                     kReduceThreads, 0, st, scratch,
                                     pl.blocks, m, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
