// Shared device helpers of the package's kernels.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace re {

constexpr float kBig = 1e30f;

// Four floats that move in one 16-byte load or store.
struct alignas(16) F4 {
  float v[4];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// NaN-propagating min / max (jnp.minimum / torch.minimum semantics;
// fminf/fmaxf would drop a NaN operand). On the card one min.NaN /
// max.NaN instruction each (sm_80 and later); a NaN comes out as the
// canonical NaN either way.
#ifndef RE_HOST_SEQUENTIAL
__device__ __forceinline__ float pmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float pmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
#else
inline float pmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
inline float pmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
#endif

// x ** e for x >= 0 as exp(log(x) * e): 0 -> 0 (the JAX kernels' _pow).
__device__ __forceinline__ float pow_el(float x, float e) {
  return expf(logf(x) * e);
}

// Two float16 packed in the bits of one float32 -> (lo, hi). Exact,
// subnormals, inf and NaN included.
__device__ __forceinline__ void unpack_half2(float f, float& lo, float& hi) {
  const unsigned int bits = __float_as_uint(f);
  lo = __half2float(__ushort_as_half(static_cast<unsigned short>(bits & 0xFFFFu)));
  hi = __half2float(__ushort_as_half(static_cast<unsigned short>(bits >> 16)));
}

// Octahedral-half2x16 normal -> unit normal; a packed 0.0 (background,
// no normal) decodes to (0, 0, 0), not to oct-decode(0, 0).
__device__ __forceinline__ void unpack_normal(float packed, float& nx,
                                              float& ny, float& nz) {
  float fx, fy;
  unpack_half2(packed, fx, fy);
  fx = fx * 2.0f - 1.0f;
  fy = fy * 2.0f - 1.0f;
  const float z = 1.0f - fabsf(fx) - fabsf(fy);
  const float t = fmaxf(-z, 0.0f);
  const float x = fx + (fx >= 0.0f ? -t : t);
  const float y = fy + (fy >= 0.0f ? -t : t);
  const float n = fmaxf(sqrtf(x * x + y * y + z * z), 1e-20f);
  const bool valid = __float_as_uint(packed) != 0u;
  nx = valid ? x / n : 0.0f;
  ny = valid ? y / n : 0.0f;
  nz = valid ? z / n : 0.0f;
}

// floor(x) as an int, as core/math3d.py::floor_int32 converts: NaN -> 0,
// saturated at +-2^30 (every caller clamps further, to the frame).
__device__ __forceinline__ int floor_int(float x) {
  constexpr float kLim = 1073741824.0f;
  const float f = floorf(x);
  if (f != f) return 0;
  return static_cast<int>(f < -kLim ? -kLim : (f > kLim ? kLim : f));
}

// A block's dynamic shared-memory array. (The host build of the sources
// in tests/test_torch_cuda_sources.py, which runs threads one after the
// other, defines it and block_load for itself; the other block helpers
// below have a host twin.)
#ifndef RE_DYNAMIC_SHARED
#define RE_DYNAMIC_SHARED(T, name) extern __shared__ T name[]
#endif

#ifndef RE_HOST_SEQUENTIAL
// Copy n floats from device memory to shared memory with the whole
// block, then synchronise it.
__device__ __forceinline__ void block_load(float* dst, const float* src,
                                           int n) {
  const int nt = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < n; i += nt) {
    dst[i] = src[i];
  }
  __syncthreads();
}

// fill(i) for every i in [0, n), spread over the block's threads, then
// synchronise: a cooperative fill of shared memory.
template <class Fill>
__device__ __forceinline__ void block_fill(int n, Fill fill) {
  const int nt = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < n; i += nt) {
    fill(i);
  }
  __syncthreads();
}

// fill(i, j) for every i in [0, rows), j in [0, cols), the threads of a
// block row walking j (so a warp takes consecutive j), then synchronise.
template <class Fill>
__device__ __forceinline__ void block_fill_2d(int rows, int cols, Fill fill) {
  for (int i = threadIdx.y; i < rows; i += blockDim.y) {
    for (int j = threadIdx.x; j < cols; j += blockDim.x) fill(i, j);
  }
  __syncthreads();
}

// Ordered stream compaction over the block. keep(i) is tested for the
// indices from `begin` on, one thread an index, a block-width at a time;
// a warp ballot and a prefix over the block's warps give each kept index
// its slot in index order, and store(slot, i) runs for the first `cap`
// of them. Returns how many were stored (the same on every thread) and
// sets `next` to where a later round must go on from (`end` once all
// fit). Every thread of the block calls it; the block size is a multiple
// of 32. The stores are visible to the whole block on return, and the
// block may read them until its next call.
template <class Keep, class Store>
__device__ __forceinline__ int block_compact(int begin, int end, int cap,
                                             Keep keep, Store store,
                                             int& next) {
  __shared__ int s_warp[32];
  __shared__ int s_next;
  const int nt = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int count = 0;
  int pos = begin;
  while (pos < end && count < cap) {
    const int i = pos + tid;
    const bool hit = i < end && keep(i);
    const unsigned int m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();  // also: every thread is done reading the last round
    int before = 0, total = 0;
    for (int k = 0; k < (nt >> 5); ++k) {
      const int c = s_warp[k];
      before += k < warp ? c : 0;
      total += c;
    }
    const int slot = count + before + __popc(m & ((1u << lane) - 1u));
    if (hit && slot < cap) store(slot, i);
    if (hit && slot == cap) s_next = i;  // the first index that did not fit
    __syncthreads();
    if (count + total > cap) {
      next = s_next;
      return cap;
    }
    count += total;
    pos += nt;
  }
  next = min(pos, end);
  return count;
}

// block_compact with k consecutive indices a thread, so a round tests
// k block-widths: thread t tests begin + t k .. begin + t k + k - 1, a
// shuffle scan over the warp and a prefix over the block's warps give
// each kept index its slot in index order. Same contract, result and
// `next` as block_compact; fewer rounds, so fewer barriers, and each
// thread's k loads are independent.
template <int K, class Keep, class Store>
__device__ __forceinline__ int block_compact_wide(int begin, int end, int cap,
                                                  Keep keep, Store store,
                                                  int& next) {
  __shared__ int s_warp[32];
  __shared__ int s_next;
  const int nt = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int count = 0;
  int pos = begin;
  while (pos < end && count < cap) {
    const int i0 = pos + tid * K;
    unsigned int hits = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      hits |= (i0 + k < end && keep(i0 + k)) ? 1u << k : 0u;
    }
    const int c = __popc(hits);
    int incl = c;  // inclusive scan of c over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      incl += lane >= d ? v : 0;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();  // also: every thread is done reading the last round
    int before = 0, total = 0;
    for (int k = 0; k < (nt >> 5); ++k) {
      const int cw = s_warp[k];
      before += k < warp ? cw : 0;
      total += cw;
    }
    int slot = count + before + incl - c;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if ((hits >> k) & 1u) {
        if (slot < cap) store(slot, i0 + k);
        if (slot == cap) s_next = i0 + k;  // the first index that did not fit
        ++slot;
      }
    }
    __syncthreads();
    if (count + total > cap) {
      next = s_next;
      return cap;
    }
    count += total;
    pos += nt * K;
  }
  next = min(pos, end);
  return count;
}
#else
// Threads run one after another in the host build of the sources: the
// block's first thread fills it all, the others find it filled.
template <class Fill>
inline void block_fill(int n, Fill fill) {
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    for (int i = 0; i < n; ++i) fill(i);
  }
}

template <class Fill>
inline void block_fill_2d(int rows, int cols, Fill fill) {
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    for (int i = 0; i < rows; ++i) {
      for (int j = 0; j < cols; ++j) fill(i, j);
    }
  }
}

// Each thread compacts the whole list itself (a later round overwrites
// it before the next thread runs), with the same slots and the same
// `next` where a round overflows.
template <class Keep, class Store>
inline int block_compact(int begin, int end, int cap, Keep keep, Store store,
                         int& next) {
  int count = 0;
  for (int i = begin; i < end; ++i) {
    if (!keep(i)) continue;
    if (count == cap) {
      next = i;
      return count;
    }
    store(count++, i);
  }
  next = end;
  return count;
}

template <int K, class Keep, class Store>
inline int block_compact_wide(int begin, int end, int cap, Keep keep,
                              Store store, int& next) {
  return block_compact(begin, end, cap, keep, store, next);
}
#endif

}  // namespace re
