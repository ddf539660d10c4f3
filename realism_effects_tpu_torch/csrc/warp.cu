// Bounded-window per-pixel warp: fetch tex at the per-pixel target
// (ty, tx) (+ fraction fy, fx), nearest / bilinear / Catmull-Rom 4x4 /
// the reference's 5-tap Catmull-Rom (`reproject.frag:212-255`).
//
// Replaces ops/pallas/warp.py::_warp_kernel (window_warp). Semantics:
// targets clipped to +-2^20; each filter tap is clamped to the frame,
// then to the window (+-ky rows around the pixel widened by the filter
// reach, +-kx_tap columns); the flag marks displacements inside
// +-ky / +-kx_flag. catrom5 drops the four corner texels.
//
// On the H100 the kernel is bound by bytes: per pixel it reads the two
// int32 targets, two float32 fractions and writes C floats + a flag;
// the up to 12 texel reads of a pixel fall inside a few cache lines that
// its neighbours share, so L1/L2 serve them. One thread per output
// pixel, direct global loads, all channels of a tap from one contiguous
// (H, W, C) texel. The first version ran 256 x 1 blocks and moved each
// float of a texel and of the output on its own: catrom5 at C = 4 made
// 48 scalar 4-byte loads a pixel (the compiler cannot prove a texel
// 16-byte aligned) and 4 stores 16 bytes apart, and the 4 footprint rows
// a pixel shares with the pixels above and below it were left to L2.
// Design: where C = 4 and the texture is 16-byte aligned (checked by the
// entry point, not assumed) each texel is one 16-byte load, and at C = 4
// the pixel's output one 16-byte store; the filtered modes run 32 x 8
// blocks, so the warps of a block share their footprint rows through
// L1, and the Catmull-Rom modes are held to 40 registers, so 6 blocks
// fit an SM. The TPU's lane-split gathers and dense vertical selects
// have no counterpart here.
//
// Multi-target nearest fetch: N targets (ty, tx) (N, H, W) of one
// texture, each with the nearest mode's clamps (frame, then +-ky rows /
// +-kx columns) and flag. Replaces ops/pallas/warp.py::_warp_multi_kernel
// (window_warp_multi). That kernel's lane-split window holds only for
// kx <= 32; this one takes any kx with the reference gather's semantics.
// A thread per pixel walks the N targets: for target t the threads of a
// warp read and write consecutive pixels of plane t, so the index loads
// and the value and flag stores coalesce.
#include "common.cuh"

namespace {

using re::clampi;

enum Mode { kNearest = 0, kBilinear = 1, kCatrom = 2, kCatrom5 = 3 };

__device__ __forceinline__ void catrom_weights(float f, float* w) {
  const float f2 = f * f;
  const float f3 = f2 * f;
  w[0] = f2 - 0.5f * (f3 + f);
  w[1] = 1.5f * f3 - 2.5f * f2 + 1.0f;
  w[3] = 0.5f * (f3 - f2);
  w[2] = 1.0f - w[0] - w[1] - w[3];
}

// The C floats of texel `col` of a texture row: one 16-byte load where
// C = 4 and the texture is 16-byte aligned (vec), else C 4-byte loads.
template <int C>
__device__ __forceinline__ void load_texel(const float* __restrict__ row,
                                           int col, int vec, float* t) {
  if constexpr (C == 4) {
    if (vec) {
      const re::F4 v = reinterpret_cast<const re::F4*>(row)[col];
#pragma unroll
      for (int c = 0; c < 4; ++c) t[c] = v.v[c];
      return;
    }
  }
  const float* p = row + static_cast<size_t>(col) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) t[c] = p[c];
}

// Blocks an SM the compiler must fit: 6 for the Catmull-Rom modes at up
// to 4 channels (at most 40 registers a thread), whose loads then have
// more warps to hide behind (measured faster on the H100); else the
// compiler's choice.
template <int MODE, int C>
__host__ __device__ constexpr int min_blocks() {
  return (MODE == kCatrom || MODE == kCatrom5) && C <= 4 ? 6 : 1;
}

template <int MODE, int C>
__global__ void __launch_bounds__(256, min_blocks<MODE, C>())
warp_kernel(const float* __restrict__ tex, const int* __restrict__ ty,
            const int* __restrict__ tx, const float* __restrict__ fy,
            const float* __restrict__ fx, float* __restrict__ out,
            uint8_t* __restrict__ flag, int h, int w, int ky, int kx_flag,
            int kx_tap, int vec) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int p = y * w + x;
  constexpr int NB = MODE == kNearest ? 1 : (MODE == kBilinear ? 2 : 4);
  constexpr int B0 = (MODE == kCatrom || MODE == kCatrom5) ? -1 : 0;
  const int lim = 1 << 20;
  const int tyc = clampi(ty[p], -lim, lim);
  const int txc = clampi(tx[p], -lim, lim);
  const int dy = tyc - y;
  const int dx = txc - x;
  flag[p] = (abs(dy) <= ky && abs(dx) <= kx_flag) ? 1 : 0;

  const int dyc = clampi(dy, -ky, ky);
  const int v_lo = -ky + B0;
  const int v_hi = ky + B0 + NB - 1;
  int rows[NB];
  int cols[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    rows[b] = y + clampi(clampi(dyc + B0 + b, -y, h - 1 - y), v_lo, v_hi);
    cols[b] = x + clampi(clampi(txc + B0 + b, 0, w - 1) - x, -kx_tap, kx_tap);
  }
  float wx[NB];
  float wy[NB];
  if constexpr (MODE == kNearest) {
    wx[0] = 1.0f;
    wy[0] = 1.0f;
  } else if constexpr (MODE == kBilinear) {
    const float fxv = fx[p];
    const float fyv = fy[p];
    wx[0] = 1.0f - fxv;
    wx[NB - 1] = fxv;
    wy[0] = 1.0f - fyv;
    wy[NB - 1] = fyv;
  } else {
    catrom_weights(fx[p], wx);
    catrom_weights(fy[p], wy);
  }

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float row[C];
#pragma unroll
    for (int c = 0; c < C; ++c) row[c] = 0.0f;
    const float* trow = tex + static_cast<size_t>(rows[b]) * w * C;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      if (MODE == kCatrom5 && (b == 0 || b == 3) && (k == 0 || k == 3)) {
        continue;  // the 5-tap filter's zero-weight corners
      }
      float t[C];
      load_texel<C>(trow, cols[k], vec, t);
#pragma unroll
      for (int c = 0; c < C; ++c) row[c] = row[c] + t[c] * wx[k];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = acc[c] + row[c] * wy[b];
  }
  if constexpr (C == 4) {  // `out` is 16-byte aligned (the entry checks)
    re::F4 v;
#pragma unroll
    for (int c = 0; c < 4; ++c) v.v[c] = acc[c];
    reinterpret_cast<re::F4*>(out)[p] = v;
  } else {
    float* o = out + static_cast<size_t>(p) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = acc[c];
  }
}

// Blocks of 256 threads: 32 x 8 for the filtered modes, whose pixels
// share footprint rows with the rows above and below; 256 x 1 for
// nearest, which measured no faster in 2-D blocks.
template <int MODE>
cudaError_t launch_mode(const float* tex, const int* ty, const int* tx,
                        const float* fy, const float* fx, float* out,
                        uint8_t* flag, int h, int w, int c, int ky,
                        int kx_flag, int kx_tap, int vec,
                        cudaStream_t stream) {
  constexpr int bx = MODE == kNearest ? 256 : 32;
  constexpr int by = 256 / bx;
  if (h / by + (h % by != 0) > 65535) return cudaErrorInvalidValue;
  const dim3 block(bx, by);
  const dim3 grid(static_cast<unsigned>(w / bx + (w % bx != 0)),
                  static_cast<unsigned>(h / by + (h % by != 0)));
#define RE_WARP_CASE(CC)                                                   \
  case CC:                                                                 \
    warp_kernel<MODE, CC><<<grid, block, 0, stream>>>(                     \
        tex, ty, tx, fy, fx, out, flag, h, w, ky, kx_flag, kx_tap, vec);   \
    break;
  switch (c) {
    RE_WARP_CASE(1)
    RE_WARP_CASE(2)
    RE_WARP_CASE(3)
    RE_WARP_CASE(4)
    RE_WARP_CASE(5)
    RE_WARP_CASE(6)
    RE_WARP_CASE(7)
    RE_WARP_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef RE_WARP_CASE
  return cudaGetLastError();
}

template <int C>
__global__ void warp_multi_kernel(const float* __restrict__ tex,
                                  const int* __restrict__ ty,
                                  const int* __restrict__ tx,
                                  float* __restrict__ out,
                                  uint8_t* __restrict__ flag, int h, int w,
                                  int n, int ky, int kx) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t p = static_cast<size_t>(y) * w + x;
  const int lim = 1 << 20;
  for (int t = 0; t < n; ++t) {
    const size_t q = t * hw + p;
    const int tyc = clampi(ty[q], -lim, lim);
    const int txc = clampi(tx[q], -lim, lim);
    const int dy = tyc - y;
    const int dx = txc - x;
    flag[q] = (abs(dy) <= ky && abs(dx) <= kx) ? 1 : 0;
    const int dyv = clampi(clampi(clampi(dy, -ky, ky), -y, h - 1 - y), -ky, ky);
    const int col = x + clampi(clampi(txc, 0, w - 1) - x, -kx, kx);
    const float* src = tex + (static_cast<size_t>(y + dyv) * w + col) * C;
    float* o = out + q * C;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = src[c];
  }
}

}  // namespace

// ---- host entry points ----
// tex (h, w, c) float32, c <= 8; ty, tx int32, fy, fx float32 (h, w)
// (fractions unused by mode 0); out (h, w, c) float32, 16-byte aligned;
// flag (h, w) one byte a pixel.
extern "C" int re_warp(const float* tex, const int* ty, const int* tx,
                       const float* fy, const float* fx, float* out,
                       uint8_t* flag, int h, int w, int c, int mode, int ky,
                       int kx_flag, int kx_tap, void* stream) {
  if (h < 0 || w < 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (h == 0 || w == 0) return cudaSuccess;
  const int vec = c == 4 && reinterpret_cast<uintptr_t>(tex) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kNearest:
      return launch_mode<kNearest>(tex, ty, tx, fy, fx, out, flag, h, w, c,
                                   ky, kx_flag, kx_tap, vec, s);
    case kBilinear:
      return launch_mode<kBilinear>(tex, ty, tx, fy, fx, out, flag, h, w, c,
                                    ky, kx_flag, kx_tap, vec, s);
    case kCatrom:
      return launch_mode<kCatrom>(tex, ty, tx, fy, fx, out, flag, h, w, c,
                                  ky, kx_flag, kx_tap, vec, s);
    case kCatrom5:
      return launch_mode<kCatrom5>(tex, ty, tx, fy, fx, out, flag, h, w, c,
                                   ky, kx_flag, kx_tap, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int re_warp_multi(const float* tex, const int* ty, const int* tx,
                             float* out, uint8_t* flag, int h, int w, int c,
                             int n, int ky, int kx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(256);
  const dim3 grid((w + 255) / 256, h);
#define RE_WARP_MULTI_CASE(CC)                                            \
  case CC:                                                                \
    warp_multi_kernel<CC><<<grid, block, 0, s>>>(tex, ty, tx, out, flag,  \
                                                 h, w, n, ky, kx);        \
    break;
  switch (c) {
    RE_WARP_MULTI_CASE(1)
    RE_WARP_MULTI_CASE(2)
    RE_WARP_MULTI_CASE(3)
    RE_WARP_MULTI_CASE(4)
    RE_WARP_MULTI_CASE(5)
    RE_WARP_MULTI_CASE(6)
    RE_WARP_MULTI_CASE(7)
    RE_WARP_MULTI_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef RE_WARP_MULTI_CASE
  return cudaGetLastError();
}
