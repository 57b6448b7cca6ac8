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
// 1.2 MB written.  The neighbouring direction_streamed.cu reads W twice
// (from device memory, or from L2 when W is still there); this kernel reads
// it once whatever L2 holds.
//
// What the design does about it.  The TPU kernel parks the tiles of W in
// VMEM in phase 0 and emits d from the parked copy in phase 1.  On Hopper
// the on-chip store that outlives a phase is the shared memory of blocks
// that stay resident, and the phases are separated by a grid-wide barrier:
//
//   one cooperative launch of at most one block per SM; block b owns a
//   range of `cols` consecutive columns.
//   phase 0: the block copies its columns of S, Y and g into dynamic shared
//     memory with cp.async (every copy of the block in flight at once), then
//     one warp per row sums W[r, :] . g over the parked columns and writes
//     partials[r, b] (row-major in r, so that phase 1 reads each row's
//     partials from neighbouring addresses).
//   grid barrier (cooperative_groups::this_grid().sync()).
//   phase 1: every block sums the partials over the blocks in the same
//     fixed order (one warp per row), forms u = C wg, and writes its columns
//     of d from the parked copy.
//
// No atomics, so every run gives the same result.  The ragged edge is the
// last block's shorter range; W is never padded or copied.  gamma is read
// through a device pointer, so the caller never syncs for it.
//
// The cap.  The parked bytes are (2m + 1) * n * 4, spread over the SMs; a
// block can use the card's opt-in shared memory (227 KB on an H100) less
// the 512 bytes kept for wg and u.  sqn_direction_max_n works the largest n
// out from the current device's properties; a larger n is refused and the
// caller takes direction_streamed.cu instead.
//
// What the time is made of at the flagship shape: mostly a chain of
// latencies (the cooperative launch, the first loads, the sum, the grid
// barrier, the partials, u, the expand), which the byte count does not
// shorten; 16-byte copies were measured and gained nothing.
//
// Plain C interface, loaded with ctypes.  The launch is on the caller's
// stream, on the current device; the function returns the launch's error
// code.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMem = 32;               // largest m (pairs) the kernel takes
constexpr int kHeadFloats = 4 * kMaxMem;  // u and wg ahead of the parked tiles
constexpr int kMinCols = 256;  // columns per block, at least, where they fit
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// partials is written before the grid barrier and read after it by other
// blocks: no __restrict__, and the reads bypass L1.
__global__ void __launch_bounds__(kThreads, 1)
    direction_one_read(const float* __restrict__ s,
                       const float* __restrict__ y,
                       const float* __restrict__ g,
                       const float* __restrict__ cmat,
                       const float* __restrict__ gamma, float* __restrict__ d,
                       float* partials, int m, int64_t n, int cols) {
  extern __shared__ float smem[];
  float* u = smem;                 // [2m]
  float* wg = smem + 2 * kMaxMem;  // [2m]
  float* park = smem + kHeadFloats;  // [2m + 1][cols]: S, Y, g
  const int two_m = 2 * m;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * cols;
  const int64_t left = n - j0;
  const int mine = left <= 0 ? 0 : left < cols ? static_cast<int>(left) : cols;

  // Phase 0: park this block's columns, then its share of W g.
  for (int r = 0; r <= two_m; ++r) {
    const float* src =
        (r < m ? s + r * n : r < two_m ? y + (r - m) * n : g) + j0;
    float* dst = park + r * cols;
    for (int c = threadIdx.x; c < mine; c += kThreads) {
      __pipeline_memcpy_async(dst + c, src + c, sizeof(float));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const float* gs = park + two_m * cols;
  for (int r = warp; r < two_m; r += kWarps) {
    const float* row = park + r * cols;
    float t = 0.f;
    for (int c = lane; c < mine; c += 32) t = fmaf(row[c], gs[c], t);
    t = warp_sum(t);
    if (lane == 0) partials[r * gridDim.x + blockIdx.x] = t;
  }

  cg::this_grid().sync();

  // Phase 1: wg in a fixed order, u = C wg, then d from the parked columns.
  for (int r = warp; r < two_m; r += kWarps) {
    float t = 0.f;
    for (int b = lane; b < gridDim.x; b += 32) {
      t += __ldcg(partials + r * gridDim.x + b);
    }
    t = warp_sum(t);
    if (lane == 0) wg[r] = t;
  }
  __syncthreads();
  if (threadIdx.x < two_m) {
    float v = 0.f;
    for (int k = 0; k < two_m; ++k) {
      v = fmaf(cmat[threadIdx.x * two_m + k], wg[k], v);
    }
    u[threadIdx.x] = v;
  }
  __syncthreads();
  const float gam = *gamma;
  for (int c = threadIdx.x; c < mine; c += kThreads) {
    float t = 0.f;
    for (int r = 0; r < two_m; ++r) t = fmaf(u[r], park[r * cols + c], t);
    d[j0 + c] = fmaf(gam, gs[c], t);
  }
}

// What the kernel needs to know of the current device, read once per
// device.  usable is false where the card cannot launch the kernel at all.
struct Card {
  bool ready;
  bool usable;
  int sms;
  int max_cols_floats;  // floats of parked columns a block can hold
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
          &per_sm, direction_one_read, kThreads, smem) == cudaSuccess &&
      per_sm >= 1;
  cd.sms = sms;
  cd.max_cols_floats = smem / static_cast<int>(sizeof(float)) - kHeadFloats;
  cd.usable = ok && sms >= 1 && cd.max_cols_floats >= 1;
  cd.ready = true;
  return cd;
}

// The launch: blocks (at most one per SM) and columns per block; blocks is
// 0 where the shape does not fit the card.
struct Plan {
  int blocks;
  int cols;
};

Plan plan(int m, long long n) {
  const Card& cd = card();
  if (!cd.usable || m < 1 || m > kMaxMem || n < 1) return {0, 0};
  const long long max_cols = cd.max_cols_floats / (2 * m + 1);
  if (max_cols < 1) return {0, 0};
  const long long want = max_cols < kMinCols ? max_cols : kMinCols;
  long long blocks = (n + want - 1) / want;
  if (blocks > cd.sms) blocks = cd.sms;
  const long long cols = (n + blocks - 1) / blocks;
  if (cols > max_cols) return {0, 0};
  return {static_cast<int>(blocks), static_cast<int>(cols)};
}

}  // namespace

extern "C" {

// The largest n sqn_direction takes for m pairs on the current device: the
// parked columns of all SMs' blocks; 0 if m is out of range or the card
// cannot launch the kernel.
long long sqn_direction_max_n(int m) {
  const Card& cd = card();
  if (!cd.usable || m < 1 || m > kMaxMem) return 0;
  return static_cast<long long>(cd.sms) * (cd.max_cols_floats / (2 * m + 1));
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
  int64_t n64 = n;
  int cols = pl.cols;
  void* args[] = {&s, &y, &g, &c, &gamma, &d, &scratch, &m, &n64, &cols};
  const size_t smem =
      sizeof(float) * (kHeadFloats + static_cast<size_t>(2 * m + 1) * cols);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(direction_one_read), dim3(pl.blocks),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
