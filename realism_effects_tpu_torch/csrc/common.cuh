// Shared device helpers of the package's kernels.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace re {

constexpr float kBig = 1e30f;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// NaN-propagating min / max (jnp.minimum / torch.minimum semantics;
// fminf/fmaxf would drop a NaN operand).
__device__ __forceinline__ float pmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float pmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

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

// A block's dynamic shared-memory array. (The host build of the sources
// in tests/test_torch_cuda_sources.py, which runs threads one after the
// other, defines it and block_load for itself.)
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

// Wait until every thread of the block is done with shared memory.
__device__ __forceinline__ void block_sync() { __syncthreads(); }
#else
inline void block_sync() {}
#endif

}  // namespace re
