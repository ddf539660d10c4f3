// Two stencils over (H, W, C) float32 images.
//
// Neighborhood AABB: per-channel min / max over the (2r+1)^2 window of
// each pixel (`reproject.frag:53-81`). A texel whose channel 0 is
// negative, or that lies outside the frame, counts as +1e30 for the min
// and -1e30 for the max (the TPU kernel's fill).
//
// Replaces ops/pallas/stencil.py::_minmax_kernel (neighborhood_minmax).
// On the H100 it is bound by bytes: C floats in and 2C floats out per
// pixel; the (2r+1)^2 re-reads of each texel hit L1/L2. Design: one
// thread per output pixel with direct loads; min/max are exact, so the
// result equals the plain version bit for bit.
//
// 3x3 unsharp mask (`SharpnessEffect.js:4-31`): edge-replicated box blur,
// then max(c + (c - blur) * s, 0). Replaces
// ops/pallas/stencil.py::_sharpness_kernel (sharpness_3x3), in its
// arithmetic as XLA compiles it: the sum in that kernel's order (for the
// rows y-1, y, y+1 in turn, acc = ((acc + left) + centre) + right), blur
// as the product acc * f32(1/9), and both multiply-adds contracted (the
// explicit fmaf below; -fmad=false leaves every other operation
// separate). Bound by bytes (C floats in and out a
// pixel; the 9 reads of a texel hit L1). One thread per (pixel,
// channel) over the interleaved layout, so loads and stores coalesce; a
// block row is an image row and C is a template parameter, so the index
// arithmetic is 32-bit with no run-time division.
#include "common.cuh"

namespace {

template <int C>
__global__ void minmax_kernel(const float* __restrict__ tex,
                              float* __restrict__ mn, float* __restrict__ mx,
                              int h, int w, int r) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  float lo[C];
  float hi[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    lo[c] = INFINITY;
    hi[c] = -INFINITY;
  }
  for (int dy = -r; dy <= r; ++dy) {
    const int yy = y + dy;
    for (int dx = -r; dx <= r; ++dx) {
      const int xx = x + dx;
      const bool inside = yy >= 0 && yy < h && xx >= 0 && xx < w;
      const float* t = tex + (static_cast<size_t>(inside ? yy : y) * w +
                              (inside ? xx : x)) * C;
      const bool ok = inside && t[0] >= 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float v = t[c];
        lo[c] = re::pmin(lo[c], ok ? v : re::kBig);
        hi[c] = re::pmax(hi[c], ok ? v : -re::kBig);
      }
    }
  }
  const size_t o = (static_cast<size_t>(y) * w + x) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    mn[o + c] = lo[c];
    mx[o + c] = hi[c];
  }
}

template <int C>
__global__ void sharpness_kernel(const float* __restrict__ tex,
                                 float* __restrict__ out, int h, int w,
                                 float s) {
  // blockIdx.y is the row; the threads walk its w * C floats
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (j >= w * C) return;
  const int x = j / C;
  const int ch = j - x * C;
  const int xl = max(x - 1, 0) * C + ch;
  const int xr = min(x + 1, w - 1) * C + ch;
  float acc = 0.0f;
  for (int dy = -1; dy <= 1; ++dy) {
    const float* row = tex + static_cast<size_t>(re::clampi(y + dy, 0, h - 1)) * w * C;
    acc = acc + row[xl];
    acc = acc + row[j];
    acc = acc + row[xr];
  }
  const size_t i = static_cast<size_t>(y) * w * C + j;
  const float cur = tex[i];
  const float d = fmaf(-acc, static_cast<float>(1.0 / 9.0), cur);
  out[i] = re::pmax(fmaf(d, s, cur), 0.0f);
}

}  // namespace

// ---- host entry points ----
extern "C" int re_minmax(const float* tex, float* mn, float* mx, int h, int w,
                         int c, int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(256);
  const dim3 grid((w + 255) / 256, h);
#define RE_MINMAX_CASE(CC)                                               \
  case CC:                                                               \
    minmax_kernel<CC><<<grid, block, 0, s>>>(tex, mn, mx, h, w, r);      \
    break;
  switch (c) {
    RE_MINMAX_CASE(1)
    RE_MINMAX_CASE(2)
    RE_MINMAX_CASE(3)
    RE_MINMAX_CASE(4)
    RE_MINMAX_CASE(5)
    RE_MINMAX_CASE(6)
    RE_MINMAX_CASE(7)
    RE_MINMAX_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef RE_MINMAX_CASE
  return cudaGetLastError();
}

// params: {sharpness}
extern "C" int re_sharpness(const float* tex, float* out, int h, int w, int c,
                            const float* params, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(256);
  const dim3 grid((w * c + 255) / 256, h);
#define RE_SHARPNESS_CASE(CC)                                                 \
  case CC:                                                                    \
    sharpness_kernel<CC><<<grid, block, 0, s>>>(tex, out, h, w, params[0]);   \
    break;
  switch (c) {
    RE_SHARPNESS_CASE(1)
    RE_SHARPNESS_CASE(2)
    RE_SHARPNESS_CASE(3)
    RE_SHARPNESS_CASE(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef RE_SHARPNESS_CASE
  return cudaGetLastError();
}
