// Collapsed SQN two-loop direction on Hopper:
//
//     d = gamma * g + W^T (C (W g)),   W = [S; Y]  ([2m, n]),  C [2m, 2m]
//
// Replaces the Pallas TPU kernel
// stochqn_tpu/ops/pallas/two_loop_kernel.py::direction_streamed (pallas_call
// at :309).  S and Y are stored float32 or bfloat16 (upcast per element);
// g, C, gamma and d are float32; every sum is accumulated in float32.
//
// What bounds it on the card: bytes.  The math is 4 * 2m * n FLOPs against
// 2 * 2m * n * sizeof(storage) bytes of W, about 0.5 FLOP per byte, far
// below the H100's ~20 FLOP/byte float32 balance point.  At the flagship
// shape (m = 10, n = 292,083, float32) W is 23.4 MB.  Two passes over it
// move 46.7 MB per step if the second pass misses L2, 23.4 MB if it hits
// (W fits the 50 MB L2).
//
// What the design does about it.  The TPU kernel walks its grid in order and
// carries W g in VMEM scratch from one grid step to the next; on Hopper
// blocks run in parallel and in no order, so the work is three launches:
//
//   1. project_partials: a grid that strides over n.  Each thread keeps
//      its 2m running dot products W[r, j] * g[j] in registers (g is read
//      once per column, W once per element, coalesced), and each block
//      reduces them to partials[block, 2m].  No atomics, so the result is
//      the same from run to run.
//   2. mix: one block sums the partials in a fixed order (one warp per row
//      of W) into wg = W g and forms u = C wg.
//   3. expand: one thread per column, d[j] = gamma * g[j] + sum_r u[r] W[r, j],
//      with u in shared memory.  Launched right after pass 1, so W is
//      likely still in L2.
//
// The ragged edge is masked (j < n); W is never padded or copied.  gamma is
// read through a device pointer, so the caller never syncs for it.  Reading
// W from HBM once (W parked in shared memory of a persistent grid, or in
// L2), TMA and wide loads are later work.
//
// Plain C interface, loaded with ctypes.  Every launch is on the caller's
// stream; the function returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMixThreads = 1024;
constexpr int kMaxMem = 32;  // largest m (pairs) the kernels take

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Pass 1: partials[b, r] = sum over the columns j of block b of W[r, j] g[j].
// MAXM bounds m at compile time so the accumulators stay in registers.
template <typename T, int MAXM>
__global__ void __launch_bounds__(kThreads)
    project_partials(const T* __restrict__ s, const T* __restrict__ y,
                     const float* __restrict__ g, int m, int64_t n,
                     float* __restrict__ partials) {
  float acc_s[MAXM];
  float acc_y[MAXM];
#pragma unroll
  for (int r = 0; r < MAXM; ++r) {
    acc_s[r] = 0.f;
    acc_y[r] = 0.f;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       j < n; j += stride) {
    const float gj = g[j];
#pragma unroll
    for (int r = 0; r < MAXM; ++r) {
      if (r < m) {
        acc_s[r] = fmaf(to_f32(s[r * n + j]), gj, acc_s[r]);
        acc_y[r] = fmaf(to_f32(y[r * n + j]), gj, acc_y[r]);
      }
    }
  }

  __shared__ float red[kWarps][2 * MAXM];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < MAXM; ++r) {
    if (r < m) {  // m is uniform over the block: no divergent shuffle
      const float a = warp_sum(acc_s[r]);
      const float b = warp_sum(acc_y[r]);
      if (lane == 0) {
        red[warp][r] = a;
        red[warp][m + r] = b;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * m) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w][threadIdx.x];
    partials[static_cast<int64_t>(blockIdx.x) * 2 * m + threadIdx.x] = t;
  }
}

// Pass 2 (one block): wg = sum_b partials[b, :] in a fixed order, one warp
// per row of W; u = C wg.
__global__ void __launch_bounds__(kMixThreads)
    mix(const float* __restrict__ partials, int num_partials, int two_m,
        const float* __restrict__ c, float* __restrict__ u) {
  __shared__ float wg[2 * kMaxMem];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < two_m; r += kMixThreads / 32) {
    float t = 0.f;
    for (int b = lane; b < num_partials; b += 32) {
      t += partials[static_cast<int64_t>(b) * two_m + r];
    }
    t = warp_sum(t);
    if (lane == 0) wg[r] = t;
  }
  __syncthreads();
  if (threadIdx.x < two_m) {
    float v = 0.f;
    for (int k = 0; k < two_m; ++k) {
      v = fmaf(c[threadIdx.x * two_m + k], wg[k], v);
    }
    u[threadIdx.x] = v;
  }
}

// Pass 3: d[j] = gamma * g[j] + sum_r u[r] W[r, j].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    expand(const T* __restrict__ s, const T* __restrict__ y,
           const float* __restrict__ g, const float* __restrict__ u,
           const float* __restrict__ gamma, int m, int64_t n,
           float* __restrict__ d) {
  __shared__ float us[2 * kMaxMem];
  if (threadIdx.x < 2 * m) us[threadIdx.x] = u[threadIdx.x];
  __syncthreads();
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  float t = 0.f;
  for (int r = 0; r < m; ++r) t = fmaf(us[r], to_f32(s[r * n + j]), t);
  for (int r = 0; r < m; ++r) t = fmaf(us[m + r], to_f32(y[r * n + j]), t);
  d[j] = fmaf(*gamma, g[j], t);
}

template <typename T, int MAXM>
void launch_project(const T* s, const T* y, const float* g, int m, int64_t n,
                    float* partials, int num_partials, cudaStream_t stream) {
  project_partials<T, MAXM>
      <<<num_partials, kThreads, 0, stream>>>(s, y, g, m, n, partials);
}

template <typename T>
int run(const void* s_v, const void* y_v, const float* g, const float* c,
        const float* gamma, float* d, float* scratch, int m, int64_t n,
        int num_partials, cudaStream_t stream) {
  const T* s = static_cast<const T*>(s_v);
  const T* y = static_cast<const T*>(y_v);
  float* partials = scratch;
  float* u = scratch + static_cast<int64_t>(num_partials) * 2 * m;
  if (m <= 4) {
    launch_project<T, 4>(s, y, g, m, n, partials, num_partials, stream);
  } else if (m <= 8) {
    launch_project<T, 8>(s, y, g, m, n, partials, num_partials, stream);
  } else if (m <= 16) {
    launch_project<T, 16>(s, y, g, m, n, partials, num_partials, stream);
  } else {
    launch_project<T, kMaxMem>(s, y, g, m, n, partials, num_partials, stream);
  }
  mix<<<1, kMixThreads, 0, stream>>>(partials, num_partials, 2 * m, c, u);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  expand<T><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      s, y, g, u, gamma, m, n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest m (number of pairs) the kernels take.
int sqn_direction_max_mem(void) { return kMaxMem; }

// d = gamma * g + [S; Y]^T (C ([S; Y] g)).
//   s, y      [m, n] row-major, float32 (storage_bf16 = 0) or bfloat16 (1)
//   g, d      [n] float32;  c [2m, 2m] float32 row-major;  gamma [1] float32
//   scratch   float32, (num_partials + 1) * 2m elements
// Returns cudaGetLastError() after the launches (0 on success).
int sqn_direction_streamed(const void* s, const void* y, int storage_bf16,
                           const float* g, const float* c, const float* gamma,
                           float* d, float* scratch, int m, long long n,
                           int num_partials, void* stream) {
  if (m < 1 || m > kMaxMem || n < 1 || num_partials < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (storage_bf16) {
    return run<__nv_bfloat16>(s, y, g, c, gamma, d, scratch, m, n,
                              num_partials, st);
  }
  return run<float>(s, y, g, c, gamma, d, scratch, m, n, num_partials, st);
}

}  // extern "C"
