// Two stencils over (H, W, C) float32 images.
//
// Neighborhood AABB: per-channel min / max over the (2r+1)^2 window of
// each pixel (`reproject.frag:53-81`). A texel whose channel 0 is
// negative, or that lies outside the frame, counts as +1e30 for the min
// and -1e30 for the max (the TPU kernel's fill).
//
// Replaces ops/pallas/stencil.py::_minmax_kernel (neighborhood_minmax).
// On the H100 the first kernel (a thread a pixel, direct loads) was
// bound by instruction issue, not bytes: at r = 2 each pixel took 25
// taps of 4 scalar loads, a bounds test and 8 NaN-checked min/max, about
// 1,000 instructions, 4.6x its bytes bound. Design: the window is
// separable. A block of 32 x 8 threads owns a 32 x 16 tile; a row pass
// takes, for every row of the tile and its r-halo, the min and max over
// 2r+1 texels (one 16-byte load each at C = 4, L1 serving the overlap,
// with the validity rule folded in as the texel is loaded) into shared
// memory, and a column pass takes 2r+1 of those rows per output: 2(2r+1)
// comparisons a channel instead of (2r+1)^2, each one min.NaN / max.NaN
// instruction, and mn and mx go out as one texel store each. (Staging
// the tile and halo in shared memory first was slower on the H100: its
// 44 KB a block held an SM to 5 blocks.) Min and max are exact and NaN-propagating in any order, so the result equals
// the plain version bit for bit (a window that holds both -0 and +0 may
// give either, which is value-equal). Any radius works: the row pass's
// rows are sized from r, and above the card's opt-in shared-memory limit
// (r > 105 at C = 4) the same kernel loads every tap directly.
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

constexpr int kMmBX = 32;  // minmax block: 32 x 8 threads
constexpr int kMmBY = 8;
constexpr int kMmPY = 2;   // rows a thread: the tile is 32 x 16
constexpr int kMmTH = kMmBY * kMmPY;

// One texel of C floats, aligned as far as its size allows (16 bytes at
// C = 4), so that it moves in one load or store.
template <int C>
struct alignas(C % 4 == 0 ? 16 : C % 2 == 0 ? 8 : 4) Texel {
  float v[C];
};

// The dynamic shared memory of the row-pass route, in 16-byte units.
struct alignas(16) Shared16 {
  float v[4];
};

// Shared bytes of the row-pass route at radius r: the row pass's min and
// max over the tile's rows and the r-halo rows.
template <int C>
size_t minmax_smem(int r) {
  return 2 * (kMmTH + 2 * static_cast<size_t>(r)) * kMmBX * sizeof(Texel<C>);
}

template <int C>
__device__ __forceinline__ void tmin(Texel<C>& a, const Texel<C>& b) {
#pragma unroll
  for (int c = 0; c < C; ++c) a.v[c] = re::pmin(a.v[c], b.v[c]);
}
template <int C>
__device__ __forceinline__ void tmax(Texel<C>& a, const Texel<C>& b) {
#pragma unroll
  for (int c = 0; c < C; ++c) a.v[c] = re::pmax(a.v[c], b.v[c]);
}

// separable != 0: the row and column passes; 0: each tap loaded directly.
template <int C>
__global__ void __launch_bounds__(kMmBX * kMmBY)
minmax_kernel(const float* __restrict__ tex, float* __restrict__ mn,
              float* __restrict__ mx, int h, int w, int r, int separable) {
  using T = Texel<C>;
  const int x0 = blockIdx.x * kMmBX;
  const int y0 = blockIdx.y * kMmTH;
  const int x = x0 + threadIdx.x;
  const bool vec = reinterpret_cast<uintptr_t>(tex) % alignof(T) == 0;
  // texel (gy, gx) as the min and the max see it
  const auto fold = [&](int gy, int gx, T& lo, T& hi) {
    T t;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    if (inside) {
      const float* src = tex + (static_cast<size_t>(gy) * w + gx) * C;
      if (vec) {
        t = *reinterpret_cast<const T*>(src);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) t.v[c] = src[c];
      }
    }
    const bool ok = inside && t.v[0] >= 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      lo.v[c] = ok ? t.v[c] : re::kBig;
      hi.v[c] = ok ? t.v[c] : -re::kBig;
    }
  };
  const auto store = [&](int y, const T& lo, const T& hi) {
    const size_t o = (static_cast<size_t>(y) * w + x) * C;
    *reinterpret_cast<T*>(mn + o) = lo;
    *reinterpret_cast<T*>(mx + o) = hi;
  };

  if (!separable) {
    for (int i = 0; i < kMmPY; ++i) {
      const int y = y0 + threadIdx.y * kMmPY + i;
      if (x >= w || y >= h) continue;
      T lo, hi;
      fold(y - r, x - r, lo, hi);  // taken again below: min, max idempotent
      for (int dy = -r; dy <= r; ++dy) {
        for (int dx = -r; dx <= r; ++dx) {
          T a, b;
          fold(y + dy, x + dx, a, b);
          tmin(lo, a);
          tmax(hi, b);
        }
      }
      store(y, lo, hi);
    }
    return;
  }

  RE_DYNAMIC_SHARED(Shared16, s_minmax);
  const int th = kMmTH + 2 * r;
  T* r_lo = reinterpret_cast<T*>(s_minmax);  // th x 32: the row pass's min
  T* r_hi = r_lo + th * kMmBX;               // and max
  re::block_fill_2d(th, kMmBX, [&](int i, int j) {
    const int gy = y0 - r + i;
    const int gx = x0 - r + j;
    T lo, hi;
    fold(gy, gx, lo, hi);
#pragma unroll 4
    for (int d = 1; d <= 2 * r; ++d) {
      T a, b;
      fold(gy, gx + d, a, b);
      tmin(lo, a);
      tmax(hi, b);
    }
    r_lo[i * kMmBX + j] = lo;
    r_hi[i * kMmBX + j] = hi;
  });
  for (int i = 0; i < kMmPY; ++i) {
    const int row = threadIdx.y * kMmPY + i;
    const int y = y0 + row;
    if (x >= w || y >= h) continue;
    const T* a = r_lo + row * kMmBX + threadIdx.x;
    const T* b = r_hi + row * kMmBX + threadIdx.x;
    T lo = a[0];
    T hi = b[0];
    for (int d = 1; d <= 2 * r; ++d) {
      tmin(lo, a[d * kMmBX]);
      tmax(hi, b[d * kMmBX]);
    }
    store(y, lo, hi);
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

template <int C>
int launch_minmax(const float* tex, float* mn, float* mx, int h, int w, int r,
                  cudaStream_t s) {
  const size_t smem = minmax_smem<C>(r);
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  const bool separable = smem <= static_cast<size_t>(optin);
  if (separable && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(minmax_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 block(kMmBX, kMmBY);
  const dim3 grid((w + kMmBX - 1) / kMmBX, (h + kMmTH - 1) / kMmTH);
  minmax_kernel<C><<<grid, block, separable ? smem : 0, s>>>(
      tex, mn, mx, h, w, r, separable ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// ---- host entry points ----
extern "C" int re_minmax(const float* tex, float* mn, float* mx, int h, int w,
                         int c, int r, void* stream) {
  if (r < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return launch_minmax<1>(tex, mn, mx, h, w, r, s);
    case 2: return launch_minmax<2>(tex, mn, mx, h, w, r, s);
    case 3: return launch_minmax<3>(tex, mn, mx, h, w, r, s);
    case 4: return launch_minmax<4>(tex, mn, mx, h, w, r, s);
    case 5: return launch_minmax<5>(tex, mn, mx, h, w, r, s);
    case 6: return launch_minmax<6>(tex, mn, mx, h, w, r, s);
    case 7: return launch_minmax<7>(tex, mn, mx, h, w, r, s);
    case 8: return launch_minmax<8>(tex, mn, mx, h, w, r, s);
    default: return cudaErrorInvalidValue;
  }
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
