// Poisson tap fetch: out[k, y, x, :] = bundle[iy[k, y, x], ix[k, y, x], :]
// for the denoiser's taps (targets clamped into the frame).
//
// Replaces ops/pallas/poisson_taps.py::_taps_kernel (poisson_taps_dense).
// The TPU kernel selected each tap from a VMEM slab over every (dy, dx)
// of a static window, because an XLA gather is priced per index; its
// result is bit-identical to the clamped nearest gather, which is what
// this kernel does, with no window limit. Bound by bytes: two int32
// targets and C floats out a (tap, pixel); the bundle reads of nearby
// pixels share cache lines. One thread per (tap, pixel, channel): a
// warp's stores are 32 consecutive floats (a per-pixel thread copying C
// floats would store with a C-float stride). A block row is a tap and C
// a template parameter, so the index arithmetic needs no run-time
// division (h * w * C must stay below 2^31).
#include "common.cuh"

namespace {

template <int C>
__global__ void taps_kernel(const float* __restrict__ bundle,
                            const int* __restrict__ iy,
                            const int* __restrict__ ix,
                            float* __restrict__ out, int h, int w) {
  // blockIdx.y is the tap; the threads walk its h * w * C output floats
  const int hw = h * w;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= hw * C) return;
  const int p = j / C;
  const int ch = j - p * C;
  const size_t q = static_cast<size_t>(blockIdx.y) * hw + p;
  const int yy = re::clampi(iy[q], 0, h - 1);
  const int xx = re::clampi(ix[q], 0, w - 1);
  out[q * C + ch] = bundle[(static_cast<size_t>(yy) * w + xx) * C + ch];
}

}  // namespace

// ---- host entry points ----
extern "C" int re_poisson_taps(const float* bundle, const int* iy,
                               const int* ix, float* out, int h, int w, int c,
                               int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0 || h == 0 || w == 0) return cudaSuccess;
  const dim3 block(256);
  const dim3 grid((h * w * c + 255) / 256, n);
#define RE_TAPS_CASE(CC)                                                  \
  case CC:                                                                \
    taps_kernel<CC><<<grid, block, 0, s>>>(bundle, iy, ix, out, h, w);    \
    break;
  switch (c) {
    RE_TAPS_CASE(1)
    RE_TAPS_CASE(2)
    RE_TAPS_CASE(3)
    RE_TAPS_CASE(4)
    RE_TAPS_CASE(5)
    RE_TAPS_CASE(6)
    RE_TAPS_CASE(7)
    RE_TAPS_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef RE_TAPS_CASE
  return cudaGetLastError();
}
