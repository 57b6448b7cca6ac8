// Collapsed SQN two-loop direction on Hopper, for pairs of any size:
//
//     d = gamma * g + W^T (C (W g)),   W = [S; Y]  ([2m, n]),  C [2m, 2m]
//
// Replaces the Pallas TPU kernel
// stochqn_tpu/ops/pallas/two_loop_kernel.py::direction_streamed (pallas_call
// at :309).  S and Y are stored float32 or bfloat16 (upcast per element);
// g, C, gamma and d are float32; every sum is accumulated in float32.
//
// What bounds it on the card: bytes.  The math is 4 * 2m * n FLOPs against
// 2m * n * sizeof(storage) bytes of W, about 0.5 FLOP per byte, far below
// the H100's ~20 FLOP/byte float32 balance point.  W g has to be complete
// before any d[j] can be written, so W is needed twice; what the card can
// keep between the two uses is the shared memory of its SMs (30 MB on an
// H100) and its L2 (50 MB).  At n = 1,000,000 and m = 10 the float32 pairs
// are 80 MB: a third parks in shared memory, and what L2 can hold of the
// rest has to come back from L2, not from device memory.
//
// What the design does about it.  The TPU kernel walks its grid in order and
// carries W g in VMEM from one grid step to the next; on Hopper blocks run in
// parallel and in no order, and the store that outlives a phase is the
// shared memory of blocks that stay resident.  One cooperative launch of at
// most one block per SM; block b owns `cols` consecutive columns:
//
//   phase 0: where the block's columns of S, Y and g fit its shared memory,
//     it copies them there with cp.async, 16 bytes a copy and all of them
//     in flight at once, in the storage type (bfloat16 parks twice the
//     columns).  Where they do not, the first `park` columns are copied
//     first, into a buffer of their own, and stay; the others pass in
//     chunks of about kChunkBytes through a ring of kStages buffers, and the
//     last kStages chunks stay.  The chunks whose buffer is refilled
//     ("gone") are read again in phase 1.  The last `l2_chunks` of them,
//     sized from the card's L2, are copied under the normal L2 policy and
//     everything else under evict_first, so that L2 still holds those at
//     the grid barrier.  One warp per row sums W[r, :] . g over what has
//     arrived, each lane in a fixed order, and writes partials[r, b].
//   grid barrier (cooperative_groups::this_grid().sync()).
//   phase 1: every block sums the partials over the blocks in the same fixed
//     order (one warp per row), forms u = C (W g) itself, and writes its
//     columns of d: the gone columns straight from global memory, the last
//     one first: those L2 kept, under evict_first, so that they leave L2
//     after this last use, then the older ones, from device memory; then
//     the columns shared memory holds.
//
// Measured at n = 1,000,000, m = 10, float32 on an H100: copying the gone
// chunks L2 keeps under evict_last instead of the normal policy gained
// nothing, and their lines outlived the launch (reads of phase 1 under
// evict_first do not demote them), taking L2 from the kernels after it.
//
// There is no cap on n: what does not fit the shared memory is re-read, and
// a card with little shared memory parks little.  The blocks, the columns
// per block, the parked columns, the ring, the chunks left to L2 and the
// scratch are worked out here from the device's properties.  No setting of
// the L2 outlives the launch: the policies travel with its copies and loads.
//
// Rows are not 16-byte aligned: row r starts r * n elements after row 0, so
// with an odd n every row has its own phase, and so has g.  A copy of a row
// segment therefore starts at the 16-byte boundary below the segment and
// ends at the one above it, and the row's copy in shared memory keeps the
// phase it has in device memory: every copy is a whole aligned 16-byte
// vector.  (The few elements it takes along belong to the neighbouring
// columns or rows and are never read; only where such a vector would reach
// outside the tensor, the segment's own elements are copied one by one.)
// The sums and phase 1 read single elements at consecutive addresses.
// Streaming the columns through registers instead (16-byte loads, the sums
// kept per thread) was measured and was slower: a thread cannot keep enough
// loads in flight.  Bulk copies (cp.async.bulk, one per row segment of a
// chunk, issued by one warp) were measured too and were slower at the
// widths shared memory allows: their cost per copy held each step of the
// ring to one chunk's latency.
//
// No atomics and a fixed order of every sum, so every run gives the same
// bits.  W is never padded or copied; gamma is read through a device
// pointer, so the caller never syncs for it.
//
// Plain C interface, loaded with ctypes.  The launch is on the caller's
// stream, on the current device; the function returns the launch's error
// code (a cooperative launch whose grid does not fit is refused, not
// queued).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMem = 32;      // largest m (pairs) the kernel takes
constexpr int kMaxRows = 2 * kMaxMem;
constexpr int kRowsPerWarp = kMaxRows / kWarps;  // rows a warp sums
constexpr int kStages = 3;       // buffers of the ring
constexpr int kChunkBytes = 64 << 10;  // a chunk's bytes of W and g, about
constexpr int kL2Percent = 75;   // share of the L2 the gone chunks take
constexpr int kExpand = 4;       // columns a thread writes per step of phase 1
constexpr int kMinCols = 1024;   // columns per block, at least, where n allows
constexpr int kMaxDevices = 64;

// Shared memory ahead of the rows, in floats: wg, the phase of every row of
// W and of g, for the parked buffer and a ring buffer a (u[r], start of row
// r) pair per row of W (past the last row: (0, start of row 0), so that a
// loop over the rows may run on to a multiple of 4).
constexpr int kOffWg = 0;
constexpr int kOffMis = kOffWg + kMaxRows;
constexpr int kOffParkRow = kOffMis + kMaxRows + 16;
constexpr int kOffRingRow = kOffParkRow + 2 * kMaxRows;
constexpr int kHeadFloats = kOffRingRow + 2 * kMaxRows;
constexpr int kHeadBytes = kHeadFloats * static_cast<int>(sizeof(float));
static_assert(kHeadBytes % 16 == 0, "the rows start 16-byte aligned");

// A row segment of `width` columns (a multiple of the 16-byte vector where
// another segment follows it) takes ld elements: the segment, the phase
// ahead of it, rounded up to whole vectors.
__host__ __device__ constexpr int row_ld(int width, int vec) {
  return (width + vec - 1) / vec * vec + vec;
}
// Bytes of a buffer of `width` columns of all 2m rows and of g.
__host__ __device__ constexpr long long buffer_bytes(int m, int width,
                                                     int esize) {
  return static_cast<long long>(2 * m) * row_ld(width, 16 / esize) * esize +
         static_cast<long long>(row_ld(width, 4)) * 4;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The L2 policy of the copies and loads whose lines should leave L2 before
// others: what shared memory keeps, and what L2 could not keep anyway.
__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

// An element no thread writes during the launch: under the L2 policy pol
// where kHinted, else a plain load.
template <bool kHinted>
__device__ __forceinline__ float read_once(const float* p, uint64_t pol) {
  if constexpr (kHinted) {
    float v;
    asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
                 : "=f"(v)
                 : "l"(p), "l"(pol));
    return v;
  } else {
    return *p;
  }
}
template <bool kHinted>
__device__ __forceinline__ __nv_bfloat16 read_once(const __nv_bfloat16* p,
                                                   uint64_t pol) {
  if constexpr (kHinted) {
    unsigned short v;
    asm volatile("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;"
                 : "=h"(v)
                 : "l"(p), "l"(pol));
    return __ushort_as_bfloat16(v);
  } else {
    return *p;
  }
}

// One warp copies `width` elements from src to dst + mis, where mis is the
// number of elements src lies past a 16-byte boundary and dst is 16-byte
// aligned: whole aligned vectors with cp.async (under the L2 policy pol
// where hinted), from the boundary below src to the one above src + width.
// [lo, hi) is the tensor src belongs to; the first or the last vector may
// reach outside it, and lane 0 copies the segment's own elements of such a
// vector one by one.
template <typename E>
__device__ __forceinline__ void copy_segment(E* dst, const E* src, int mis,
                                             int width, const E* lo,
                                             const E* hi, int lane,
                                             uint64_t pol, bool hinted) {
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  const E* base = src - mis;
  const int vectors = (mis + width + V - 1) / V;
  const int first = base < lo ? 1 : 0;
  const int last = base + vectors * V > hi ? vectors - 1 : vectors;
  if (hinted) {
    for (int v = first + lane; v < last; v += 32) {
      asm volatile(
          "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;" ::"r"(
              static_cast<uint32_t>(__cvta_generic_to_shared(dst + v * V))),
          "l"(base + v * V), "l"(pol)
          : "memory");
    }
  } else {
    for (int v = first + lane; v < last; v += 32) {
      __pipeline_memcpy_async(dst + v * V, base + v * V, 16);
    }
  }
  if (lane == 0) {
    for (int v = 0; v < vectors; v += vectors > 1 ? vectors - 1 : 1) {
      if (v >= first && v < last) continue;  // copied above
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int e = v * V + i;
        if (e >= mis && e < mis + width) dst[e] = base[e];
      }
    }
  }
}

// partials is written before the grid barrier and read after it by other
// blocks: no __restrict__, and the reads bypass L1.
//
// T is the storage type.  Block b owns the columns b * cols ...; the first
// `park` of them (a multiple of the 16-byte vector) stay in shared memory,
// the others pass through a ring of kStages buffers of `chunk` columns.
//
// A cp.async is accepted no faster than memory delivers, and a warp has only
// so many in flight: every warp makes its share of a chunk's copies (a few
// warps alone do not fill the memory pipe), and is held for about as long
// as the chunk takes to arrive, so a step of the ring costs the chunk's
// transfer plus its sums, which are kept short.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    direction_parked(const T* __restrict__ s, const T* __restrict__ y,
                     const float* __restrict__ g,
                     const float* __restrict__ cmat,
                     const float* __restrict__ gamma, float* __restrict__ d,
                     float* partials, int m, int64_t n, int64_t cols, int park,
                     int chunk, int l2_chunks) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int ESIZE = static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  float* head = reinterpret_cast<float*>(smem);
  float* wg = head + kOffWg;
  int* mis = reinterpret_cast<int*>(head + kOffMis);  // [2m + 1], g last
  // where row r starts in the parked buffer and in a ring buffer, each with
  // u[r] beside it once u is known
  float2* park_row = reinterpret_cast<float2*>(head + kOffParkRow);  // [2m]
  float2* ring_row = reinterpret_cast<float2*>(head + kOffRingRow);  // [2m]

  const int two_m = 2 * m;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * cols;
  const int64_t left = n - j0;
  const int64_t mine = left <= 0 ? 0 : left < cols ? left : cols;
  const int P = mine < park ? static_cast<int>(mine) : park;
  const int64_t rest = mine - P;
  const int chunks = chunk > 0 ? static_cast<int>((rest + chunk - 1) / chunk)
                               : 0;
  const float* gb = g + j0;

  // What phase 1 needs and the barrier does not change, fetched ahead of it:
  // gamma, and for the rows r = warp + i * kWarps of u = C wg the entries
  // C[r, lane] and C[r, lane + 32].
  const float gam = *gamma;
  float c_lo[kRowsPerWarp];
  float c_hi[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    c_lo[i] = r < two_m && lane < two_m ? cmat[r * two_m + lane] : 0.f;
    c_hi[i] = r < two_m && lane + 32 < two_m ? cmat[r * two_m + lane + 32]
                                             : 0.f;
  }

  // The buffers: the parked rows, then the ring.  A buffer holds the 2m rows
  // of W in the storage type, ld elements each, then g.
  const int ld_p = row_ld(park, VEC);
  const int ld_c = row_ld(chunk, VEC);
  unsigned char* park_buf = smem + kHeadBytes;
  unsigned char* ring = park_buf + buffer_bytes(m, park, ESIZE);
  const long long ring_stride = buffer_bytes(m, chunk, ESIZE);
  auto rows_of = [](unsigned char* buf) { return reinterpret_cast<T*>(buf); };
  auto g_of = [&](unsigned char* buf, int ld) {
    return reinterpret_cast<float*>(buf + static_cast<size_t>(two_m) * ld *
                                              ESIZE);
  };

  // The phase of a row: the elements its first column lies past a 16-byte
  // boundary.  Every segment starts a multiple of the vector after the
  // block's first column, so a row has one phase throughout.
  auto row_of = [&](int r) {
    return (r < m ? s + r * n : y + (r - m) * n) + j0;
  };
  for (int r = tid; r <= kMaxRows; r += kThreads) {
    if (r < two_m) {
      mis[r] = static_cast<int>(
          (reinterpret_cast<uintptr_t>(row_of(r)) / ESIZE) & (VEC - 1));
      park_row[r] = make_float2(0.f, __int_as_float(r * ld_p + mis[r]));
      ring_row[r] = make_float2(0.f, __int_as_float(r * ld_c + mis[r]));
    } else if (r < kMaxRows) {
      const int mis0 = static_cast<int>(
          (reinterpret_cast<uintptr_t>(row_of(0)) / ESIZE) & (VEC - 1));
      park_row[r] = make_float2(0.f, __int_as_float(mis0));
      ring_row[r] = make_float2(0.f, __int_as_float(mis0));
    }
    if (r == two_m) {
      mis[r] = static_cast<int>((reinterpret_cast<uintptr_t>(gb) >> 2) & 3);
    }
  }
  __syncthreads();

  // Copies the columns [c0, c0 + width) of every row and of g into a buffer
  // whose rows are ld elements long: one warp per row.
  const uint64_t evict_first = policy_evict_first();
  auto copy_columns = [&](unsigned char* buf, int ld, int64_t c0, int width,
                          bool hinted) {
    for (int r = warp; r <= two_m; r += kWarps) {
      if (r < two_m) {
        const T* lo = r < m ? s : y;
        copy_segment<T>(rows_of(buf) + r * ld, row_of(r) + c0, mis[r], width,
                        lo, lo + m * n, lane, evict_first, hinted);
      } else {
        copy_segment<float>(g_of(buf, ld), gb + c0, mis[two_m], width, g,
                            g + n, lane, evict_first, hinted);
      }
    }
  };
  auto chunk_width = [&](int k) {
    const int64_t w = rest - static_cast<int64_t>(k) * chunk;
    return w < chunk ? static_cast<int>(w) : chunk;
  };
  // The chunks whose buffer is refilled, `gone` of them, are read again in
  // phase 1.  The last `in_l2` of them are copied under the normal policy,
  // and everything else under evict_first (it stays in shared memory, or L2
  // could not hold it anyway), so that L2 still holds those at the barrier.
  // Where nothing passes through the ring, all is copied as normal.
  const int gone = chunks > kStages ? chunks - kStages : 0;
  const int in_l2 = gone < l2_chunks ? gone : l2_chunks;
  auto copy_chunk = [&](int slot, int k) {  // chunk k into buffer `slot`
    copy_columns(ring + slot * ring_stride, ld_c,
                 P + static_cast<int64_t>(k) * chunk, chunk_width(k),
                 k < gone - in_l2 || k >= gone);
  };

  // A warp sums the rows warp + i * kWarps of W against g, a row at a time;
  // a lane keeps 4 sums per row going, over the columns 32 apart, and adds
  // them in a fixed order.
  const int my_rows = (two_m - warp + kWarps - 1) / kWarps;
  float acc[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) acc[i] = 0.f;
  auto sum_columns = [&](unsigned char* buf, int ld, const float2* row_at,
                         int width) {
    const float* gs = g_of(buf, ld) + mis[two_m] + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (i < my_rows) {  // the same for every lane of the warp
        const T* row = rows_of(buf) +
                       __float_as_int(row_at[warp + i * kWarps].y) + lane;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int c = 0;
        for (; c + lane + 96 < width; c += 128) {
          a0 = fmaf(to_f32(row[c]), gs[c], a0);
          a1 = fmaf(to_f32(row[c + 32]), gs[c + 32], a1);
          a2 = fmaf(to_f32(row[c + 64]), gs[c + 64], a2);
          a3 = fmaf(to_f32(row[c + 96]), gs[c + 96], a3);
        }
        for (; c + lane < width; c += 32) {
          a0 = fmaf(to_f32(row[c]), gs[c], a0);
        }
        acc[i] += (a0 + a1) + (a2 + a3);
      }
    }
  };

  // Phase 0: the parked columns are one group of copies, every chunk one
  // more; groups land in the order they were committed.
  if (P > 0) copy_columns(park_buf, ld_p, 0, P, chunk > 0);
  __pipeline_commit();
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < chunks) copy_chunk(k, k);
    __pipeline_commit();
  }
  __pipeline_wait_prior(kStages - 1);  // the parked columns are here
  __syncthreads();
  if (P > 0) sum_columns(park_buf, ld_p, park_row, P);
  for (int k = 0; k < chunks; ++k) {
    __pipeline_wait_prior(kStages - 2);  // this thread's copies of chunk k
    __syncthreads();  // everyone's; and chunk k - 1 is summed by everyone
    const int nx = k + kStages - 1;
    if (nx < chunks) copy_chunk(nx % kStages, nx);
    __pipeline_commit();
    sum_columns(ring + (k % kStages) * ring_stride, ld_c, ring_row,
                chunk_width(k));
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (i < my_rows) {  // the same for every lane of the warp
      const float t = warp_sum(acc[i]);
      if (lane == 0) {
        partials[static_cast<int64_t>(warp + i * kWarps) * gridDim.x +
                 blockIdx.x] = t;
      }
    }
  }

  cg::this_grid().sync();

  // Phase 1: wg in a fixed order (a warp's rows loaded side by side, each
  // lane over the blocks 32 apart), u = C wg by one warp per row, then d.
  {
    float t[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) t[i] = 0.f;
    for (int b = lane; b < gridDim.x; b += 32) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (i < my_rows) {
          t[i] += __ldcg(partials +
                         static_cast<int64_t>(warp + i * kWarps) * gridDim.x +
                         b);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (i < my_rows) {  // the same for every lane of the warp
        const float v = warp_sum(t[i]);
        if (lane == 0) wg[warp + i * kWarps] = v;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    if (r < two_m) {  // the same for every lane of the warp
      float v = lane < two_m ? c_lo[i] * wg[lane] : 0.f;
      if (lane + 32 < two_m) v = fmaf(c_hi[i], wg[lane + 32], v);
      v = warp_sum(v);
      if (lane == 0) {
        park_row[r].x = v;
        ring_row[r].x = v;
      }
    }
  }
  __syncthreads();

  constexpr int kStep = kExpand * kThreads;
  const int64_t gone_cols = static_cast<int64_t>(gone) * chunk;  // full

  // The columns that no buffer holds any more, [P, P + gone_cols), straight
  // from global memory, the last ones first: those L2 kept, under
  // evict_first, so that they leave L2 after this last use, then the older
  // ones, from device memory.  A thread takes kGone columns kThreads apart
  // and kGoneRows rows at a time, so that it has kGone * kGoneRows loads in
  // flight.
  constexpr int kGone = 4;
  constexpr int kGoneRows = 4;
  auto gone_pass = [&](int64_t lo_col, int64_t hi_col, auto hinted) {
    constexpr bool kHinted = decltype(hinted)::value;
    const int64_t count = hi_col - lo_col;
    for (int64_t base = tid; base < count; base += kGone * kThreads) {
      int64_t col[kGone];  // of the block's columns; past the end: the last
      float t[kGone];
#pragma unroll
      for (int i = 0; i < kGone; ++i) {
        const int64_t back = base + i * kThreads;
        col[i] = hi_col - 1 - (back < count ? back : base);
        t[i] = 0.f;
      }
      for (int r = 0; r < two_m; r += kGoneRows) {
        T w[kGoneRows][kGone];
#pragma unroll
        for (int j = 0; j < kGoneRows; ++j) {
          const T* row = row_of(r + j < two_m ? r + j : 0);
#pragma unroll
          for (int i = 0; i < kGone; ++i) {
            w[j][i] = read_once<kHinted>(row + col[i], evict_first);
          }
        }
#pragma unroll
        for (int j = 0; j < kGoneRows; ++j) {
          const float u = park_row[r + j].x;  // 0 past the last row
#pragma unroll
          for (int i = 0; i < kGone; ++i) {
            t[i] = fmaf(u, to_f32(w[j][i]), t[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kGone; ++i) {
        if (base + i * kThreads < count) {
          d[j0 + col[i]] =
              fmaf(gam, read_once<kHinted>(gb + col[i], evict_first), t[i]);
        }
      }
    }
  };
  const int64_t l2_lo = P + static_cast<int64_t>(gone - in_l2) * chunk;
  gone_pass(l2_lo, P + gone_cols, std::true_type{});
  gone_pass(static_cast<int64_t>(P), l2_lo, std::false_type{});

  // The columns that shared memory holds, `total` of them: a thread takes up
  // to kExpand of them kThreads apart, and the rows 4 at a time.  locate(i)
  // gives where column i of them lies: its element of the buffer's first
  // row (in elements after the head), its g (in floats of the shared
  // memory), and which of the block's columns it is.  row_at[r] is (u[r],
  // where row r starts).
  const T* all_rows = reinterpret_cast<const T*>(smem + kHeadBytes);
  auto expand = [&](int64_t total, const float2* row_at, auto locate) {
    for (int64_t base = tid; base < total; base += kStep) {
      int row0[kExpand];
      int g_at[kExpand];
      int64_t col[kExpand];
      float t[kExpand];
#pragma unroll
      for (int i = 0; i < kExpand; ++i) {
        const int64_t at = base + i * kThreads;
        locate(at < total ? at : base, row0[i], g_at[i], col[i]);
        t[i] = 0.f;
      }
      for (int r = 0; r < two_m; r += 4) {
        float2 e[4];
        float w[4][kExpand];
#pragma unroll
        for (int j = 0; j < 4; ++j) e[j] = row_at[r + j];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int i = 0; i < kExpand; ++i) {
            w[j][i] = to_f32(all_rows[row0[i] + __float_as_int(e[j].y)]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int i = 0; i < kExpand; ++i) t[i] = fmaf(e[j].x, w[j][i], t[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kExpand; ++i) {
        if (base + i * kThreads < total) {
          d[j0 + col[i]] = fmaf(gam, head[g_at[i]], t[i]);
        }
      }
    }
  };
  // where a buffer's rows and its g start, as locate gives them
  auto rows_at = [&](unsigned char* buf) {
    return static_cast<int>((buf - smem - kHeadBytes) / ESIZE);
  };
  auto g_at_of = [&](unsigned char* buf, int ld) {
    return static_cast<int>(g_of(buf, ld) - head) + mis[two_m];
  };
  // the chunks the ring holds, in one pass: a thread's columns lie in
  // different chunks
  expand(rest - gone_cols, ring_row,
         [&](int64_t at, int& row0, int& g_at, int64_t& col) {
           const int k = static_cast<int>(at / chunk);  // of the held chunks
           const int c = static_cast<int>(at - static_cast<int64_t>(k) * chunk);
           unsigned char* buf = ring + ((gone + k) % kStages) * ring_stride;
           row0 = rows_at(buf) + c;
           g_at = g_at_of(buf, ld_c) + c;
           col = P + gone_cols + at;
         });
  expand(P, park_row, [&](int64_t at, int& row0, int& g_at, int64_t& col) {
    row0 = rows_at(park_buf) + static_cast<int>(at);
    g_at = g_at_of(park_buf, ld_p) + static_cast<int>(at);
    col = at;
  });
}

const void* kernel_of(bool bf16) {
  return bf16 ? reinterpret_cast<const void*>(direction_parked<__nv_bfloat16>)
              : reinterpret_cast<const void*>(direction_parked<float>);
}

// What the kernel needs to know of the current device, read once per
// device under a lock.  usable is false where the card cannot launch the kernel at all.
struct Card {
  bool ready;
  bool usable;
  int sms;
  int smem;  // opt-in shared memory of a block, bytes
  int l2;    // L2 cache, bytes
};

const Card& card() {
  static std::mutex lock;
  static Card cards[kMaxDevices] = {};
  static const Card none = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return none;
  }
  const std::lock_guard<std::mutex> guard(lock);
  Card& cd = cards[dev];
  if (cd.ready) return cd;
  int sms = 0, smem = 0, coop = 0, l2 = 0;
  bool ok =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
          cudaSuccess &&
      cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) ==
          cudaSuccess &&
      cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev) ==
          cudaSuccess &&
      coop != 0 && sms >= 1 &&
      // a ring of the largest m with chunks of 32 columns has to fit
      smem >= kHeadBytes + (kStages + 1) * buffer_bytes(kMaxMem, 32, 4);
  for (int t = 0; ok && t < 2; ++t) {
    int per_sm = 0;
    ok = cudaFuncSetAttribute(kernel_of(t != 0),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem) == cudaSuccess &&
         cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel_of(t != 0), kThreads, smem) == cudaSuccess &&
         per_sm >= 1;
  }
  cd.sms = sms;
  cd.smem = smem;
  cd.l2 = l2;
  cd.usable = ok;
  cd.ready = true;
  return cd;
}

// The launch: blocks (at most one per SM, so that all are resident), columns
// per block, parked columns per block, columns of a ring buffer (0: no
// ring, everything parks), the gone chunks a block leaves to L2 and the
// shared memory; blocks is 0 where the arguments are out of range or the
// card cannot launch the kernel.
struct Plan {
  int blocks;
  long long cols;
  int park;
  int chunk;
  int l2_chunks;
  size_t smem;
};

Plan plan(int m, long long n, bool bf16) {
  Plan pl = {};
  const Card& cd = card();
  if (!cd.usable || m < 1 || m > kMaxMem || n < 1) return pl;
  const int esize = bf16 ? 2 : 4;
  const int vec = 16 / esize;
  long long blocks = (n + kMinCols - 1) / kMinCols;
  if (blocks > cd.sms) blocks = cd.sms;
  pl.cols = (n + blocks - 1) / blocks;
  pl.blocks = static_cast<int>((n + pl.cols - 1) / pl.cols);
  const long long room = cd.smem - kHeadBytes;
  // the largest column count whose buffer is at most `bytes`: a multiple of
  // the vector
  auto fits = [&](long long bytes) {
    const long long per_col = 2 * m * esize + 4;
    const long long fixed = static_cast<long long>(2 * m) * vec * esize + 16;
    const long long c = bytes < fixed ? 0 : (bytes - fixed) / per_col;
    return c / vec * vec;
  };
  if (pl.cols <= fits(room)) {
    pl.park = static_cast<int>((pl.cols + vec - 1) / vec * vec);
    pl.chunk = 0;
    pl.smem = kHeadBytes + buffer_bytes(m, pl.park, esize);
    return pl;
  }
  // It does not fit: the ring takes chunks of about kChunkBytes (less where
  // kStages of those do not fit), the parked columns the rest of the room,
  // and L2 is left the gone chunks of all blocks that kL2Percent of it
  // holds.
  const long long per_col = 2 * m * esize + 4;  // bytes of W and g
  const long long cap = fits((room - buffer_bytes(m, 0, esize)) / kStages);
  if (cap < vec) return Plan{};
  long long chunk = kChunkBytes / per_col / vec * vec;
  if (chunk > cap) chunk = cap;
  if (chunk < vec) chunk = vec;
  // chunks of one width as far as it goes, so that the last, which stays,
  // is about as wide as the others
  const long long rest = pl.cols - fits(room - kStages *
                                        buffer_bytes(m, chunk, esize));
  const long long chunks = (rest + chunk - 1) / chunk;
  chunk = ((rest + chunks - 1) / chunks + vec - 1) / vec * vec;
  const long long ring = kStages * buffer_bytes(m, chunk, esize);
  pl.chunk = static_cast<int>(chunk);
  pl.park = static_cast<int>(fits(room - ring));
  const long long l2_chunks = static_cast<long long>(cd.l2) / 100 *
                              kL2Percent / (pl.blocks * chunk * per_col);
  pl.l2_chunks = static_cast<int>(l2_chunks < (1 << 30) ? l2_chunks
                                                        : (1 << 30));
  pl.smem = kHeadBytes + buffer_bytes(m, pl.park, esize) + ring;
  return pl;
}

}  // namespace

extern "C" {

// Largest m (number of pairs) the kernels take.
int sqn_direction_max_mem(void) { return kMaxMem; }

// Floats of scratch sqn_direction_streamed needs on the current device (one
// partial W g per block); 0 if the arguments are out of range or the card
// cannot launch the kernel.
long long sqn_direction_streamed_scratch(int m, long long n, int storage_bf16) {
  return static_cast<long long>(plan(m, n, storage_bf16 != 0).blocks) * 2 * m;
}

// How a launch of sqn_direction_streamed on the current device treats the n
// columns of W, written to split[0..2]: the columns that stay in shared
// memory between the two uses (read from global memory once: the parked
// columns and the chunks the ring holds last), those that phase 1 reads
// again from L2, where phase 0 left them while it copied everything else
// under evict_first, and those it reads again from device memory.  The three add up to n; all
// are 0 where the card cannot launch the kernel.
void sqn_direction_streamed_split(int m, long long n, int storage_bf16,
                                  long long* split) {
  const Plan pl = plan(m, n, storage_bf16 != 0);
  split[0] = split[1] = split[2] = 0;
  for (int b = 0; b < pl.blocks; ++b) {
    const long long left = n - b * pl.cols;
    const long long mine = left < pl.cols ? left : pl.cols;
    const long long parked = mine < pl.park ? mine : pl.park;
    long long gone = 0;
    if (pl.chunk > 0) {
      const long long chunks = (mine - parked + pl.chunk - 1) / pl.chunk;
      gone = chunks > kStages ? chunks - kStages : 0;
    }
    const long long in_l2 = gone < pl.l2_chunks ? gone : pl.l2_chunks;
    split[0] += mine - gone * pl.chunk;
    split[1] += in_l2 * pl.chunk;
    split[2] += (gone - in_l2) * pl.chunk;
  }
}

// d = gamma * g + [S; Y]^T (C ([S; Y] g)).
//   s, y      [m, n] row-major, float32 (storage_bf16 = 0) or bfloat16 (1)
//   g, d      [n] float32;  c [2m, 2m] float32 row-major;  gamma [1] float32
//   scratch   float32, sqn_direction_streamed_scratch(m, n, storage_bf16)
// Returns the launch's error code (0 on success).
int sqn_direction_streamed(const void* s, const void* y, int storage_bf16,
                           const float* g, const float* c, const float* gamma,
                           float* d, float* scratch, int m, long long n,
                           void* stream) {
  const Plan pl = plan(m, n, storage_bf16 != 0);
  if (pl.blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  int64_t n64 = n;
  int64_t cols = pl.cols;
  int park = pl.park;
  int chunk = pl.chunk;
  int l2_chunks = pl.l2_chunks;
  void* args[] = {&s, &y,   &g,    &c,    &gamma, &d,   &scratch,
                  &m, &n64, &cols, &park, &chunk, &l2_chunks};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel_of(storage_bf16 != 0), dim3(pl.blocks), dim3(kThreads), args,
      pl.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
