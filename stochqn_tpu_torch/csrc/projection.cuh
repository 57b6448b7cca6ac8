// What the two projection sources (project.cu, project_adaqn.cu) share: the
// limits of their C interfaces, the patches of an upper triangle, the
// question to the runtime of how many blocks an SM holds (asked once per
// device and m), and the launch of a kernel as a programmatic dependent of
// the work before it.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace projection {

constexpr int kMaxMem = 32;     // largest m (pairs) the kernels take
constexpr int kMaxDevices = 64;

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

inline bool valid(int m, long long n, int num_sms) {
  return m >= 1 && m <= kMaxMem && n >= 1 && num_sms >= 1;
}

// Blocks of a pass-1 kernel that one SM holds at once, asked of the runtime
// once per device and m (0: not asked yet) under a lock.  One cache per
// source: for one m a source always asks about the same kernel, threads and
// shared memory.
class BlocksPerSm {
 public:
  // opt_in() is called once per device before the first question there (it
  // asks for dynamic shared memory over 48 KB).  Returns the runtime's
  // error, and cudaErrorLaunchOutOfResources where an SM holds no block.
  template <class Kernel, class OptIn>
  cudaError_t ask(Kernel kernel, int threads, size_t smem, int m,
                  OptIn opt_in, int* per_sm) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    const std::lock_guard<std::mutex> guard(lock_);
    if (!opted_[dev]) {
      err = opt_in();
      if (err != cudaSuccess) return err;
      opted_[dev] = true;
    }
    if (cache_[dev][m] == 0) {
      int asked = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&asked, kernel,
                                                          threads, smem);
      if (err != cudaSuccess) return err;
      if (asked < 1) return cudaErrorLaunchOutOfResources;
      cache_[dev][m] = asked;
    }
    *per_sm = cache_[dev][m];
    return cudaSuccess;
  }

 private:
  std::mutex lock_;
  int cache_[kMaxDevices][kMaxMem + 1] = {};
  bool opted_[kMaxDevices] = {};
};

// Launches a kernel as a programmatic dependent of the launch before it on
// the stream: its blocks are placed while that grid still runs (once all its
// blocks have called cudaTriggerProgrammaticLaunchCompletion() or ended) and
// wait in cudaGridDependencySynchronize() for its end, so the second
// launch's latency is not added to the first one's time.  The kernel must
// touch no device memory before that call.
template <class... Params, class... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 blocks,
                             int threads, size_t smem, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = blocks;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute dependent = {};
  dependent.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &dependent;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace projection
