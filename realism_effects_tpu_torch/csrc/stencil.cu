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
// separate). Bound by bytes: C floats in and out a pixel. The first
// kernel (a thread a float, 9 scalar loads from L1 and a centre load for
// one 4-byte store) was bound by load/store issue at 41% of that bound.
// Design: a thread owns 4 consecutive floats [j, j+4) of the flattened
// row and a column of kShR = 2 rows (blocks of 128 x 2 threads; of the
// rows 1, 2, 4 and 8 a thread and three blocks timed on the H100, the
// fastest). With C <= 4 their horizontal neighbours lie in [j-4, j+8):
// three 16-byte units a row, kept in registers for the rows y-1, y and
// y+1 as the thread walks down (3 (kShR + 2) loads for 4 kShR outputs,
// one 16-byte store a row). Edge replication is decided a
// float from its flat index (x = 0 iff j < C, x = w-1 iff j >= w C - C),
// with no division. The 16-byte route runs where the entry point finds
// tex and out 16-byte aligned and w C % 4 == 0; else the same kernel
// loads and stores each float on its own.
#include "common.cuh"

namespace {

constexpr int kMmBX = 32;  // minmax block: 32 x 8 threads
constexpr int kMmBY = 8;
constexpr int kMmPY = 2;   // rows a thread: the tile is 32 x 16
constexpr int kMmTH = kMmBY * kMmPY;

constexpr int kShR = 2;     // sharpness: rows a thread
constexpr int kShBX = 128;  // sharpness block: 128 x 2 threads
constexpr int kShBY = 2;

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

// Floats [j0-4, j0+8) of a row into v, the units past the row's ends
// left unread (no output selects them).
template <bool VEC>
__device__ __forceinline__ void sharp_span(const float* __restrict__ row,
                                           int j0, int n, float (&v)[12]) {
  if (VEC) {
    const re::F4 m = *reinterpret_cast<const re::F4*>(row + j0);
    re::F4 l = m;
    re::F4 r = m;
    if (j0 >= 4) l = *reinterpret_cast<const re::F4*>(row + j0 - 4);
    if (j0 + 4 < n) r = *reinterpret_cast<const re::F4*>(row + j0 + 4);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = l.v[k];
      v[4 + k] = m.v[k];
      v[8 + k] = r.v[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const int j = j0 - 4 + k;
      v[k] = (j >= 0 && j < n) ? row[j] : 0.0f;
    }
  }
}

// One output float: a, b, c are the spans of the rows y-1, y, y+1; K the
// float's place in the thread's unit (its span index 4 + K).
template <int C, int K>
__device__ __forceinline__ float sharp_one(const float (&a)[12],
                                           const float (&b)[12],
                                           const float (&c)[12], bool has_l,
                                           bool has_r, float s) {
  float acc = 0.0f;
  acc = acc + (has_l ? a[4 + K - C] : a[4 + K]);
  acc = acc + a[4 + K];
  acc = acc + (has_r ? a[4 + K + C] : a[4 + K]);
  acc = acc + (has_l ? b[4 + K - C] : b[4 + K]);
  acc = acc + b[4 + K];
  acc = acc + (has_r ? b[4 + K + C] : b[4 + K]);
  acc = acc + (has_l ? c[4 + K - C] : c[4 + K]);
  acc = acc + c[4 + K];
  acc = acc + (has_r ? c[4 + K + C] : c[4 + K]);
  const float cur = b[4 + K];
  const float d = fmaf(-acc, static_cast<float>(1.0 / 9.0), cur);
  return re::pmax(fmaf(d, s, cur), 0.0f);
}

template <int C, bool VEC>
__global__ void sharpness_kernel(const float* __restrict__ tex,
                                 float* __restrict__ out, int h, int w,
                                 float s) {
  const int n = w * C;  // floats a row
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const int y0 = (blockIdx.y * blockDim.y + threadIdx.y) * kShR;
  if (j0 >= n || y0 >= h) return;
  // left / right neighbour inside the row (else the float itself)
  bool has_l[4], has_r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    has_l[k] = j0 + k >= C;
    has_r[k] = j0 + k < n - C;
  }
  const auto row = [&](int y) { return tex + static_cast<size_t>(y) * n; };
  float a[12], b[12], c[12];
  sharp_span<VEC>(row(max(y0 - 1, 0)), j0, n, a);
  sharp_span<VEC>(row(y0), j0, n, b);
#pragma unroll
  for (int i = 0; i < kShR; ++i) {
    const int y = y0 + i;
    if (y >= h) break;
    sharp_span<VEC>(row(min(y + 1, h - 1)), j0, n, c);
    re::F4 o;
    o.v[0] = sharp_one<C, 0>(a, b, c, has_l[0], has_r[0], s);
    o.v[1] = sharp_one<C, 1>(a, b, c, has_l[1], has_r[1], s);
    o.v[2] = sharp_one<C, 2>(a, b, c, has_l[2], has_r[2], s);
    o.v[3] = sharp_one<C, 3>(a, b, c, has_l[3], has_r[3], s);
    float* dst = out + static_cast<size_t>(y) * n + j0;
    if (VEC) {
      *reinterpret_cast<re::F4*>(dst) = o;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (j0 + k < n) dst[k] = o.v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      a[k] = b[k];
      b[k] = c[k];
    }
  }
}

template <int C>
int launch_sharpness(const float* tex, float* out, int h, int w, float sh,
                     bool vec, cudaStream_t s) {
  const int units = (w * C + 3) / 4;
  const int groups = (h + kShR - 1) / kShR;
  const dim3 block(kShBX, kShBY);
  const dim3 grid((units + kShBX - 1) / kShBX, (groups + kShBY - 1) / kShBY);
  if (vec) {
    sharpness_kernel<C, true><<<grid, block, 0, s>>>(tex, out, h, w, sh);
  } else {
    sharpness_kernel<C, false><<<grid, block, 0, s>>>(tex, out, h, w, sh);
  }
  return cudaGetLastError();
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

// params: {sharpness}. The 16-byte route where tex and out are 16-byte
// aligned and a row holds whole 16-byte units.
extern "C" int re_sharpness(const float* tex, float* out, int h, int w, int c,
                            const float* params, void* stream) {
  if (h < 1 || w < 1 || c < 1 || c > 4 ||
      static_cast<long long>(h) * w * c >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (w * c) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(tex) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  switch (c) {
    case 1: return launch_sharpness<1>(tex, out, h, w, params[0], vec, s);
    case 2: return launch_sharpness<2>(tex, out, h, w, params[0], vec, s);
    case 3: return launch_sharpness<3>(tex, out, h, w, params[0], vec, s);
    default: return launch_sharpness<4>(tex, out, h, w, params[0], vec, s);
  }
}
