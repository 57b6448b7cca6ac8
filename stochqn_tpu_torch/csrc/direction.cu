// Collapsed SQN two-loop direction on Hopper, with ONE read of the pair
// memory from device memory:
//
//     d = gamma * g + W^T (C (W g)),   W = [S; Y]  ([2m, n]),  C [2m, 2m]
//
// Replaces the Pallas TPU kernel
// stochqn_tpu/ops/pallas/two_loop_kernel.py::direction (pallas_call at
// :196).  Every input and every sum is float32, like the TPU kernel.
//
// What bounds it on the card: bytes.  The math is 4 * 2m * n FLOPs against
// (2m + 1) * n * 4 bytes read and n * 4 written, about 0.5 FLOP per byte.
// At the flagship shape (m = 10, n = 292,083) that is 24.5 MB read and
// 1.2 MB written, 7.7 us at the H100's 3.35 TB/s.  The neighbouring
// direction_streamed.cu reads W twice where it does not fit; this kernel
// reads it once whatever L2 holds.
//
// The TPU kernel parks the tiles of W in VMEM in phase 0 and emits d from
// the parked copy in phase 1.  On Hopper the on-chip store that outlives a
// phase is the shared memory of blocks that stay resident; the phases are
// separated by a grid-wide barrier where there is more than one block.
// Block b owns `cols` consecutive columns; at most one block per SM.
//
// The design follows a stage split of this kernel's first version (one
// block per SM, 4-byte cp.async copies, the sums after the park; every
// stage stamped with %globaltimer by tools/direction_ab.py, NVIDIA H100
// 80GB HBM3 at 700 W).  Of its 15.2 us at the flagship with W warm in
// L2, 2.1 us passed before the first instruction, 6 us parking W, 2 us
// summing W g after the park had landed, 1 us in the grid barrier, 2.3 us
// reading the partials and then C one element at a time, and 1.9 us
// writing d; at n = 900 the same chain took 9.4 us.  What this version does
// about each part:
//
//   - The park.  One lane of warp 0 per row arms the row's own mbarrier and
//     asks the copy engine for the row in one bulk copy (cp.async.bulk,
//     global to shared), g first.  One warp per row sums it as soon as its
//     barrier says it has landed, so the sums run under the park, and what
//     is left when the last row lands is one row's sum.  The park itself is
//     bound by what the memory system delivers to the SMs (about 6 us at the
//     flagship with W in L2, as before); splitting rows into smaller bulk
//     copies, or copying them with cp.async from every thread, was measured
//     and was slower.
//   - Rows start off a 16-byte boundary at odd n and on the interleaved
//     view sy[m:].  A row is parked as the 16-byte-aligned span around its
//     columns: its shared copy keeps the phase the row has in device memory,
//     and the up to 3 + 3 elements of the neighbouring columns (or rows) the
//     span takes along are never read.  Each 16-byte piece of the span holds
//     an element of the row, so it lies in a page the tensor's memory is
//     mapped in.
//   - Everything but the partials is fetched before the reduction, in
//     flight with the park: C into shared memory, gamma into a register.
//     After the grid barrier a lane loads all its partials at once (one L2
//     round trip), and u = C wg is formed from shared memory, one warp per
//     row.
//   - The launch is sized to the work: a block takes at least kMinCols
//     columns, so a small n runs in one block, which needs no grid barrier;
//     a block has two columns per thread up to 512 threads and asks for the
//     shared memory its columns need.  Only a grid of more than one block is
//     a cooperative launch.  Every launch is a programmatic dependent of the
//     one before it on the stream: it is placed while that one still runs,
//     arms its barriers, and waits for its end before it touches device
//     memory (one block at n = 900 then starts 1 us sooner).
//   - Phase 1 reads each parked element once from shared memory; a thread
//     takes up to kHeld of its columns at once, so that one broadcast of
//     (u[r], offset of row r) serves them all.
//
// No float atomics, and every sum in a fixed order (a lane's columns in
// order, the warp's shuffle tree, the blocks in order, each column's rows
// in order), so the same inputs give the same bits.  W is never padded or
// copied.  gamma is read through a device pointer, so the caller never
// syncs for it.
//
// The cap.  The parked bytes are (2m + 1) * n * 4, spread over the SMs; a
// block can use the card's opt-in shared memory (227 KB on an H100) less
// what it keeps ahead of the rows (the barriers, wg, u and C).
// sqn_direction_max_n works the largest n out from the current device's
// properties (361,152 at m = 10 on an H100); a larger n is refused and the
// caller takes direction_streamed.cu instead.
//
// Plain C interface, loaded with ctypes.  The launch is on the caller's
// stream, on the current device; the function returns the launch's error
// code.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

// Stage stamps: empty here; tools/direction_ab.py defines them to time
// each stage with %globaltimer.
#ifndef SQN_STAGES_BEGIN
#define SQN_STAGES_BEGIN
#define SQN_STAGE(k)
#define SQN_MARK(k)
#define SQN_STAGES_END
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kMinThreads = 128;
constexpr int kMaxThreads = 512;
constexpr int kMaxMem = 32;     // largest m (pairs) the kernel takes
constexpr int kHeld = 8;        // columns a thread takes at once in phase 1
constexpr int kBatch = 8;       // partials a lane loads at once
constexpr int kMinCols = 1024;  // columns per block, at least, where n allows
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Shared memory, in floats: the 2m + 1 row barriers (8 bytes each), wg,
// (u[r], offset of row r) pairs, C, then the 2m + 1 parked rows (S, Y, g),
// ld floats each.
struct Layout {
  int wg, u, cmat, park;
};
__host__ __device__ inline Layout layout(int m) {
  const int rows = 2 * m;
  Layout l;
  l.wg = round4(2 * (rows + 1));
  l.u = l.wg + round4(rows);
  l.cmat = l.u + round4(2 * rows);
  l.park = l.cmat + round4(rows * rows);
  return l;
}
// A row of `cols` columns keeps its phase (up to 3 elements) ahead of them.
__host__ __device__ constexpr int row_ld(int cols) { return round4(cols) + 4; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The park's barriers, one per row, each expecting one arrival: made by
// one thread, then made visible to the copy engine.
__device__ __forceinline__ void init_rows(uint64_t* bar, int rows) {
  for (int q = 0; q < rows; ++q) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_addr(bar + q))
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Row q's barrier arrives and expects `bytes` from the copy engine, then
// the bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory that completes on it.
__device__ __forceinline__ void park_row(uint64_t* bar, float* dst,
                                         const float* src, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits until row q's barrier has completed its first phase: the row has
// landed.
__device__ __forceinline__ void wait_row(const uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(b), "r"(0u)
        : "memory");
  }
}

// Phase 1 for a block: d[c] = gamma g[c] + sum_r u[r] W[r, c] over the
// block's `mine` columns, each column's sum over the rows in order.  A
// thread takes its first H columns at once, so that one read of (u[r],
// offset of row r) serves them all, and the rest one by one.
template <int H>
__device__ __forceinline__ void expand(const float2* ur, const float* park,
                                       const float* gs, float gam, float* d,
                                       int rows, int mine) {
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  float acc[H];
#pragma unroll
  for (int k = 0; k < H; ++k) acc[k] = 0.f;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const float2 e = ur[r];
    const float* row = park + __float_as_int(e.y) + tid;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      if (tid + k * threads < mine) {
        acc[k] = fmaf(e.x, row[k * threads], acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const int c = tid + k * threads;
    if (c < mine) d[c] = fmaf(gam, gs[c], acc[k]);
  }
  for (int c = tid + H * threads; c < mine; c += threads) {
    float t = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float2 e = ur[r];
      t = fmaf(e.x, park[__float_as_int(e.y) + c], t);
    }
    d[c] = fmaf(gam, gs[c], t);
  }
}

// partials is written before the grid barrier and read after it by other
// blocks: no __restrict__, and the reads bypass L1.
__global__ void __launch_bounds__(kMaxThreads, 1)
    direction_one_read(const float* __restrict__ s,
                       const float* __restrict__ y,
                       const float* __restrict__ g,
                       const float* __restrict__ cmat,
                       const float* __restrict__ gamma, float* __restrict__ d,
                       float* partials, int m, int64_t n, int cols) {
  SQN_STAGES_BEGIN
  extern __shared__ __align__(16) float smem[];
  const int two_m = 2 * m;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int threads = blockDim.x;
  const int warps = threads >> 5;
  const int blocks = gridDim.x;
  const Layout lay = layout(m);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // [2m + 1], g last
  float* wg = smem + lay.wg;                          // [2m]
  float2* ur = reinterpret_cast<float2*>(smem + lay.u);  // [2m]
  float* cs = smem + lay.cmat;                        // [2m][2m]
  float* park = smem + lay.park;                      // [2m + 1][ld]
  const int ld = row_ld(cols);
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * cols;
  const int64_t left = n - j0;
  const int mine = left <= 0 ? 0 : left < cols ? static_cast<int>(left) : cols;

  // Row q (q < 2m a row of W, q == 2m g) from this block's first column,
  // and its phase: the elements it lies past a 16-byte boundary.
  auto row_src = [&](int q) {
    return (q < m ? s + q * n : q < two_m ? y + (q - m) * n : g) + j0;
  };
  auto phase = [&](int q) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(row_src(q)) >> 2) &
                            3);
  };

  // The launch after this one on the stream may be placed now; it waits for
  // this one's end before it touches device memory, as this one does for
  // the launch before it.
  cudaTriggerProgrammaticLaunchCompletion();
  if (tid == 0) init_rows(bar, two_m + 1);
  SQN_MARK(1)
  cudaGridDependencySynchronize();

  // Phase 0.  Warp 0 parks the rows: lane i arms row q's barrier and asks
  // for the 16-byte-aligned span around the row's columns in one bulk copy,
  // g first.  The span keeps the row's phase and takes up to 3 + 3 elements
  // of the neighbouring columns (or rows) along, which are never read: each
  // 16-byte piece of the span holds an element of the row, so it lies in a
  // page the tensor's memory is mapped in.
  if (warp == 0) {
    __syncwarp();
    for (int i = lane; i <= two_m; i += 32) {
      const int q = i == 0 ? two_m : i - 1;
      const int ph = phase(q);
      park_row(bar + q, park + q * ld, row_src(q) - ph,
               static_cast<uint32_t>(round4(ph + mine)) * 4u);
    }
  }
  // C into shared memory and gamma into a register, both needed only after
  // the reduction.
  for (int k = tid; k < two_m * two_m; k += threads) {
    __pipeline_memcpy_async(cs + k, cmat + k, sizeof(float));
  }
  __pipeline_commit();
  const float gam = *gamma;
  if (tid < two_m) {
    ur[tid] = make_float2(0.f, __int_as_float(tid * ld + phase(tid)));
  }
  __syncthreads();
  SQN_STAGE(2)

  // One warp per row sums it as soon as it has landed: lane l takes the
  // columns l, l + 32, ... into four sums in turn, then the warp's tree.
  // The block's sum goes to wg (one block) or to the partials.
  const float* gs = park + two_m * ld + phase(two_m);
  wait_row(bar + two_m);
  for (int r = warp; r < two_m; r += warps) {
    const float* row = park + r * ld + phase(r);
    wait_row(bar + r);
    float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
    int c = lane;
    for (; c + 96 < mine; c += 128) {
      t0 = fmaf(row[c], gs[c], t0);
      t1 = fmaf(row[c + 32], gs[c + 32], t1);
      t2 = fmaf(row[c + 64], gs[c + 64], t2);
      t3 = fmaf(row[c + 96], gs[c + 96], t3);
    }
    for (; c < mine; c += 32) t0 = fmaf(row[c], gs[c], t0);
    const float t = warp_sum((t0 + t1) + (t2 + t3));
    if (lane == 0) {
      if (blocks == 1) {
        wg[r] = t;
      } else {
        partials[r * blocks + blockIdx.x] = t;
      }
    }
  }
  SQN_STAGE(3)

  // Over the blocks in order, after the grid barrier: a lane's loads of two
  // rows' partials all leave before its sums use the first.
  if (blocks > 1) {
    cg::this_grid().sync();
    SQN_STAGE(4)
    for (int r = warp; r < two_m; r += 2 * warps) {
      const int r2 = r + warps < two_m ? r + warps : r;
      const float* p1 = partials + r * blocks;
      const float* p2 = partials + r2 * blocks;
      float t1 = 0.f, t2 = 0.f;
      for (int b0 = 0; b0 < blocks; b0 += 32 * kBatch) {
        float v1[kBatch], v2[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int b = b0 + lane + 32 * i;
          v1[i] = b < blocks ? __ldcg(p1 + b) : 0.f;
          v2[i] = b < blocks ? __ldcg(p2 + b) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          t1 += v1[i];
          t2 += v2[i];
        }
      }
      t1 = warp_sum(t1);
      t2 = warp_sum(t2);
      if (lane == 0) {
        wg[r] = t1;
        wg[r2] = t2;
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  SQN_STAGE(5)

  // u = C wg from shared memory, one warp per row.
  for (int r = warp; r < two_m; r += warps) {
    float v = 0.f;
    for (int k = lane; k < two_m; k += 32) {
      v = fmaf(cs[r * two_m + k], wg[k], v);
    }
    v = warp_sum(v);
    if (lane == 0) ur[r].x = v;
  }
  __syncthreads();
  SQN_STAGE(6)

  // Phase 1: d from the parked columns.
  float* dj = d + j0;
  switch ((mine + threads - 1) / threads) {
    case 0: break;
    case 1: expand<1>(ur, park, gs, gam, dj, two_m, mine); break;
    case 2: expand<2>(ur, park, gs, gam, dj, two_m, mine); break;
    case 3: expand<3>(ur, park, gs, gam, dj, two_m, mine); break;
    case 4: expand<4>(ur, park, gs, gam, dj, two_m, mine); break;
    case 5: expand<5>(ur, park, gs, gam, dj, two_m, mine); break;
    case 6: expand<6>(ur, park, gs, gam, dj, two_m, mine); break;
    default: expand<kHeld>(ur, park, gs, gam, dj, two_m, mine); break;
  }
  SQN_STAGE(7)
  SQN_STAGES_END
}

// What the kernel needs to know of the current device, read once per
// device.  usable is false where the card cannot launch the kernel at all.
struct Card {
  bool ready;
  bool usable;
  int sms;
  int smem_floats;  // opt-in shared memory of a block, in floats
};

const Card& card() {
  static Card cards[kMaxDevices] = {};
  static const Card none = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return none;
  }
  Card& cd = cards[dev];
  if (cd.ready) return cd;
  int sms = 0, smem = 0, coop = 0, per_sm = 0;
  const bool ok =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
          cudaSuccess &&
      cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) ==
          cudaSuccess &&
      coop != 0 &&
      cudaFuncSetAttribute(direction_one_read,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) == cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, direction_one_read, kMaxThreads, smem) == cudaSuccess &&
      per_sm >= 1;
  cd.sms = sms;
  cd.smem_floats = smem / static_cast<int>(sizeof(float));
  cd.usable = ok && sms >= 1;
  cd.ready = true;
  return cd;
}

// The most columns a block parks for m pairs: the rows' ld within what the
// head leaves.
int max_cols(const Card& cd, int m) {
  const int avail = cd.smem_floats - layout(m).park;
  const int ld = avail / (2 * m + 1) / 4 * 4;
  return ld - 4;
}

// The launch: blocks (at most one per SM), columns per block and threads
// per block; blocks is 0 where the shape does not fit the card.  A block
// takes at least kMinCols columns where n allows, so a small n runs in one
// block, which needs no grid barrier.
struct Plan {
  int blocks;
  int cols;
  int threads;
};

Plan plan(int m, long long n) {
  const Card& cd = card();
  if (!cd.usable || m < 1 || m > kMaxMem || n < 1) return {0, 0, 0};
  const long long most = max_cols(cd, m);
  if (most < 1) return {0, 0, 0};
  const long long want = most < kMinCols ? most : kMinCols;
  long long blocks = (n + want - 1) / want;
  if (blocks > cd.sms) blocks = cd.sms;
  const long long cols = (n + blocks - 1) / blocks;
  if (cols > most) return {0, 0, 0};
  // two columns per thread, in whole warps, from kMinThreads to kMaxThreads
  long long threads = ((cols + 1) / 2 + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < kMinThreads) threads = kMinThreads;
  return {static_cast<int>(blocks), static_cast<int>(cols),
          static_cast<int>(threads)};
}

}  // namespace

extern "C" {

// The largest n sqn_direction takes for m pairs on the current device: the
// parked columns of all SMs' blocks; 0 if m is out of range or the card
// cannot launch the kernel.
long long sqn_direction_max_n(int m) {
  const Card& cd = card();
  if (!cd.usable || m < 1 || m > kMaxMem) return 0;
  const int most = max_cols(cd, m);
  return most < 1 ? 0 : static_cast<long long>(cd.sms) * most;
}

// Floats of scratch sqn_direction needs (one partial W g per block); 0 if
// the shape does not fit.
long long sqn_direction_scratch(int m, long long n) {
  return static_cast<long long>(plan(m, n).blocks) * 2 * m;
}

// d = gamma * g + [S; Y]^T (C ([S; Y] g)), W read from device memory once.
//   s, y      [m, n] float32 row-major, 1 <= m <= 32
//   g, d      [n] float32;  c [2m, 2m] float32 row-major;  gamma [1] float32
//   scratch   float32, sqn_direction_scratch(m, n) floats
// Returns the launch's error code (0 on success); cudaErrorInvalidValue for
// an n over sqn_direction_max_n(m).
int sqn_direction(const float* s, const float* y, const float* g,
                  const float* c, const float* gamma, float* d, float* scratch,
                  int m, long long n, void* stream) {
  const Plan pl = plan(m, n);
  if (pl.blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n64 = n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.blocks);
  cfg.blockDim = dim3(pl.threads);
  cfg.dynamicSmemBytes =
      sizeof(float) * (layout(m).park + static_cast<size_t>(2 * m + 1) *
                                            row_ld(pl.cols));
  cfg.stream = static_cast<cudaStream_t>(stream);
  // a programmatic dependent of the launch before it (see the kernel), and
  // for a grid barrier every block resident: a cooperative launch
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.blocks > 1 ? 2 : 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, direction_one_read, s, y, g, c, gamma, d,
                         scratch, m, n64, pl.cols);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
