// Poisson tap fetch: out[k, y, x, :] = bundle[iy[k, y, x], ix[k, y, x], :]
// for the denoiser's taps (targets clamped into the frame).
//
// Replaces ops/pallas/poisson_taps.py::_taps_kernel (poisson_taps_dense).
// The TPU kernel selected each tap from a VMEM slab over every (dy, dx)
// of a static window, because an XLA gather is priced per index; its
// result is bit-identical to the clamped nearest gather, which is what
// this kernel does, with no window limit. A copy: it equals advanced
// indexing bit for bit.
//
// On the H100 the fetch is bound by bytes: two int32 targets in and C
// floats out a (tap, pixel), with the bundle reads of nearby pixels
// sharing cache lines. The first version ran a thread per (tap, pixel,
// channel), a grid row a tap: each of a pixel's C threads re-read and
// re-clamped its targets, made one scattered 4-byte bundle load and one
// 4-byte store, and the bundle was walked once a tap, so it moved about
// a third of the card's bytes rate. Design: a block owns a 32 x 8 pixel
// tile and up to kTaps taps. Each (tap, pixel) loads its two targets
// once, coalesced, clamps them, and copies its C floats into shared
// memory, where the values of one tap and tile row lie as that row's
// run of the output (32 pixels x C floats, contiguous in `out`). The
// block then writes each run with 16-byte stores, scalar stores at the
// run's ragged ends, so the stores coalesce. A tile's taps fall within
// a few rows and columns of it, so its bundle texels come back through
// L1: direct loads (staging the tile and an 8 x 5 halo of the bundle in
// shared memory as well measured slower on the H100, 3 blocks an SM
// instead of 5). C is a template parameter; indices are 32-bit (the
// entry point refuses n * h * w * C >= 2^31); nothing in the
// per-element path divides.
#include "common.cuh"

namespace {

constexpr int kBX = 32;   // tile: 32 pixels of a row (a warp) ...
constexpr int kBY = 8;    // ... x 8 rows
constexpr int kTaps = 8;  // taps a block (grid z walks larger counts)

// floats a staged output run takes: 32 pixels x C and room to shift the
// run so that its 16-byte units in shared memory line up with those of
// `out` (a multiple of 4, so every run starts 16-byte aligned)
template <int C>
__host__ __device__ constexpr int run_floats() {
  return kBX * C + 4;
}

template <int C>
__global__ void __launch_bounds__(kBX * kBY)
taps_kernel(const float* __restrict__ bundle, const int* __restrict__ iy,
            const int* __restrict__ ix, float* __restrict__ out, int h, int w,
            int n) {
  constexpr int kRun = run_floats<C>();
  RE_DYNAMIC_SHARED(float, s_val);  // [tap][row]: the output runs
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  const int k0 = blockIdx.z * kTaps;
  const int nx = min(kBX, w - x0);
  const int ny = min(kBY, h - y0);
  const int nt = min(kTaps, n - k0);
  // output float offset of tap t's tile row r; its staged run is shifted
  // by base & 3 floats, which lines it up with `out`'s 16-byte units
  const auto run_base = [&](int t, int r) {
    return (((k0 + t) * h + y0 + r) * w + x0) * C;
  };
  // gather: (tap t, row r) x pixel j; a warp takes 32 pixels of a row
  re::block_fill_2d(nt * kBY, kBX, [&](int i, int j) {
    const int t = i / kBY;  // kBY a power of two: a shift
    const int r = i - t * kBY;
    if (r >= ny || j >= nx) return;
    const int q = ((k0 + t) * h + y0 + r) * w + x0 + j;
    const int yy = re::clampi(iy[q], 0, h - 1);
    const int xx = re::clampi(ix[q], 0, w - 1);
    const float* src = bundle + (yy * w + xx) * C;
    float* dst = s_val + i * kRun + (run_base(t, r) & 3) + j * C;
#pragma unroll
    for (int c = 0; c < C; ++c) dst[c] = src[c];
  });
  // store: warp r writes the runs of row r, one tap after another
  const int lane = threadIdx.x;
  const int r = threadIdx.y;
  if (r >= ny) return;
  const int len = nx * C;
  for (int t = 0; t < nt; ++t) {
    const int base = run_base(t, r);
    const int pad = base & 3;
    const float* s = s_val + (t * kBY + r) * kRun + pad;
    float* g = out + base;
    // floats before the first 16-byte boundary of `out`, the 16-byte
    // units after it, then the rest
    const int head = min((4 - pad) & 3, len);
    const int n4 = (len - head) >> 2;
    const int tail = head + 4 * n4;
    if (lane < head) g[lane] = s[lane];
    const re::F4* s4 = reinterpret_cast<const re::F4*>(s + head);
    re::F4* g4 = reinterpret_cast<re::F4*>(g + head);
    for (int u = lane; u < n4; u += kBX) g4[u] = s4[u];
    if (lane < len - tail) g[tail + lane] = s[tail + lane];
  }
}

template <int C>
cudaError_t launch(const float* bundle, const int* iy, const int* ix,
                   float* out, int h, int w, int n, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(min(n, kTaps)) * kBY * run_floats<C>() *
                      sizeof(float);
  if (smem > 48 * 1024) {  // C >= 6 at 8 taps: the opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        taps_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 block(kBX, kBY);
  const dim3 grid(static_cast<unsigned>(w / kBX + (w % kBX != 0)),
                  static_cast<unsigned>(h / kBY + (h % kBY != 0)),
                  static_cast<unsigned>(n / kTaps + (n % kTaps != 0)));
  taps_kernel<C><<<grid, block, smem, st>>>(bundle, iy, ix, out, h, w, n);
  return cudaGetLastError();
}

}  // namespace

// ---- host entry points ----
// bundle (h, w, c) float32, c <= 8; iy, ix (n, h, w) int32; out (n, h, w,
// c) float32, 16-byte aligned; n * h * w * c < 2^31.
extern "C" int re_poisson_taps(const float* bundle, const int* iy,
                               const int* ix, float* out, int h, int w, int c,
                               int n, void* stream) {
  if (h < 0 || w < 0 || n < 0 || c < 1 || c > 8 ||
      static_cast<long long>(n) * h * w * c >= (1LL << 31) ||
      h / kBY + (h % kBY != 0) > 65535 || n / kTaps + (n % kTaps != 0) > 65535 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (n == 0 || h == 0 || w == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return launch<1>(bundle, iy, ix, out, h, w, n, st);
    case 2: return launch<2>(bundle, iy, ix, out, h, w, n, st);
    case 3: return launch<3>(bundle, iy, ix, out, h, w, n, st);
    case 4: return launch<4>(bundle, iy, ix, out, h, w, n, st);
    case 5: return launch<5>(bundle, iy, ix, out, h, w, n, st);
    case 6: return launch<6>(bundle, iy, ix, out, h, w, n, st);
    case 7: return launch<7>(bundle, iy, ix, out, h, w, n, st);
    default: return launch<8>(bundle, iy, ix, out, h, w, n, st);
  }
}
