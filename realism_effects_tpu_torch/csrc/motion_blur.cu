// Motion blur's accumulate pass (ops/motion_blur.py::motion_blur_sweep):
// for each pixel, the sum over the (direction, radius) cells of its own
// two direction bins of the cell's float16 RGB1 texel times the cell's
// weight, the overlap of the cell's radii [lo, hi) with the side's
// jittered extent [0, u): acc += texel * max(min(u, hi) - lo, 0).
//
// Replaces no TPU kernel: the JAX package's ops/motion_blur.py sweeps
// the whole frame once per cell with XLA, and the port's plain loop
// (accumulate_plain) adds every one of the dirs x steps cells to every
// pixel, with a weight of 0 in all but the pixel's two bins. The loop is
// bound by those whole-frame reads (192 at the defaults) and their
// (steps, H, W) weight planes; here a thread walks its pixel's bins
// only, in ascending bin order (the loop's), a bin's cells in ascending
// radius, and skips every cell whose weight is 0 (on the increasing
// radius ladder, all cells past the first with u <= lo). A skipped cell
// would add texel * (+-0) = +-0 to a sum that is never -0, so the sums
// are the loop's bit for bit, in the same order, while the texel is
// finite; a float16 texel that is not (HDR above 65504) gives NaN in the
// loop's zero-weight cells and is not read here. When the two bins
// coincide (one bin, or rounding), a cell's weight is the sum of both
// sides' weights, pos + neg, as in the loop. A bin value outside
// [0, dirs), or not an integer (NaN), matches no bin, as in the loop.
// Products and sums are the loop's addcmul_: fmaf(texel, w, acc), a
// fused multiply-add, which PyTorch's CPU and CUDA kernels both make of
// self + value * t1 * t2 at value 1; the weight's own operations round
// one by one (-fmad=false).
//
// Bound on the H100 by bytes: 40 a pixel compulsory (u and bin planes
// 16, the texel 8, the sum 16); the shifted texel reads of a warp are
// 32 consecutive 8-byte texels of one cell where its pixels share a bin,
// served by L1 and L2. One thread per pixel, 128 x 1 blocks. The cell
// table (offsets as int16, radii) travels by value in the launch's
// parameters, kCells cells a launch, so nothing is uploaded a frame; a
// larger table launches once per kCells cells in ascending cell order,
// the sums carried in `acc` between launches.
#include "common.cuh"

namespace {

constexpr int kCells = 256;  // cells (direction, radius) a launch takes
constexpr int kBlock = 128;

struct MbParams {
  int w;          // the block's columns (acc, u and bin planes)
  int sw;         // the padded source's columns
  int row0;       // source row of block row 0: pad + the block's global row
  int col0;       // source column of column 0: pad
  int dirs, steps;
  int c0, n;      // first cell (d * steps + k) of this launch, and cells
  int first;      // 1: the sums start at 0, else from acc
  short dy[kCells], dx[kCells];
  float lo[kCells], hi[kCells];
};

// Four float16 channels of one source texel, one 8-byte load.
struct alignas(8) Texel {
  unsigned short v[4];
};

__device__ __forceinline__ float half_bits(unsigned short b) {
  return __half2float(__ushort_as_half(b));
}

// One side's weight of a cell: torch.clamp(torch.minimum(u, hi) - lo, min=0).
__device__ __forceinline__ float cell_weight(float u, float lo, float hi) {
  return re::pmax(re::pmin(u, hi) - lo, 0.0f);
}

// The bin of a bin plane's value, -1 where it matches none.
__device__ __forceinline__ int bin_of(float b, int dirs) {
  if (!(b >= 0.0f && b < static_cast<float>(dirs))) return -1;
  const int i = static_cast<int>(b);
  return static_cast<float>(i) == b ? i : -1;
}

__global__ void __launch_bounds__(kBlock)
motion_blur_kernel(const float* __restrict__ u_pos, const float* __restrict__ u_neg,
                   const float* __restrict__ bin_pos, const float* __restrict__ bin_neg,
                   const Texel* __restrict__ src, re::F4* __restrict__ acc,
                   const MbParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= p.w) return;
  const int pix = y * p.w + x;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  if (!p.first) {
    const re::F4 c = acc[pix];
    a0 = c.v[0];
    a1 = c.v[1];
    a2 = c.v[2];
    a3 = c.v[3];
  }
  const float up = u_pos[pix];
  const float un = u_neg[pix];
  const int bp = bin_of(bin_pos[pix], p.dirs);
  const int bn = bin_of(bin_neg[pix], p.dirs);
  const Texel* row = src + static_cast<size_t>(p.row0 + y) * p.sw + p.col0 + x;

  // bin b's cells of this launch; u2 joins only where both sides share b
  auto visit = [&](int b, float u1, float u2, bool both) {
    if (b < 0) return;
    const int c_end = min(b * p.steps + p.steps, p.c0 + p.n);
    for (int c = max(b * p.steps, p.c0); c < c_end; ++c) {
      const int i = c - p.c0;
      float wt = cell_weight(u1, p.lo[i], p.hi[i]);
      if (both) wt = wt + cell_weight(u2, p.lo[i], p.hi[i]);
      if (wt == 0.0f) continue;
      const Texel t = row[static_cast<long long>(p.dy[i]) * p.sw + p.dx[i]];
      a0 = fmaf(half_bits(t.v[0]), wt, a0);
      a1 = fmaf(half_bits(t.v[1]), wt, a1);
      a2 = fmaf(half_bits(t.v[2]), wt, a2);
      a3 = fmaf(half_bits(t.v[3]), wt, a3);
    }
  };
  if (bp == bn) {
    visit(bp, up, un, true);
  } else if (bp < bn) {
    visit(bp, up, 0.0f, false);
    visit(bn, un, 0.0f, false);
  } else {
    visit(bn, un, 0.0f, false);
    visit(bp, up, 0.0f, false);
  }
  acc[pix] = re::F4{{a0, a1, a2, a3}};
}

// ---- the reference's taps: ops/motion_blur.py::motion_blur ----
// motion_blur.frag:23-42 as the plain route computes it, one thread a
// pixel: the pixel's uv (uv_grid, at its global row), its velocity
// scaled by the intensity, the jitter from the blue-noise tile read at
// the frame's shift, the clamped start and end uvs, then samples + 1
// bilinear taps at mix(start, end, i / samples) of the float16-rounded
// source (sample_bilinear(half=True): clamp to edge, the fraction 0
// where floor lands below 0), summed onto the pixel's own colour and
// divided by samples + 2; a pixel that does not move keeps its colour
// and takes no tap (the plain route takes them and discards them).
// Each texel is rounded through float16 as it is fetched, so no float16
// copy of the source is made. The same operations in the same order as
// the plain route (-fmad=false); a division by a host scalar follows the
// plain route of the device: PyTorch on CUDA multiplies by the scalar's
// float32 reciprocal, on the CPU it divides (`recip`), so the kernel
// matches the card's plain route on the card and the CPU's in the host
// build of the sources.
//
// The TPU never had a kernel for it (the JAX package's taps are XLA);
// the plain route is about 25 whole-frame torch operations a tap. Bound
// on the H100 by bytes where no pixel moves: the pixel's colour,
// velocity and output once (the source is the colour, or in a split
// frame the gathered colour, and the 4 x 17 texels a moving pixel reads
// lie along its segment, shared by its neighbours through L1 and L2)
// and the 128 x 128 noise tile once; the taps' arithmetic, about 50
// operations a tap, depends on which pixels move.

struct TapsParams {
  int h, w;        // the block's rows and columns
  int sh, sw;      // the source's rows (the frame's height) and columns
  int row_offset;  // the block's first global row
  int tile, sy, sx;  // noise tile size and the frame's shift into it
  int samples, recip;
  float intensity, jitter, frame_speed;
  float inv_w, inv_fh, div, inv_div;  // 1 / w, 1 / sh, samples + 2, 1 / div
};

__device__ __forceinline__ float scalar_div(float a, float b, float inv, int recip) {
  return recip ? a * inv : a / b;
}

__device__ __forceinline__ float half_round(float v) {
  return __half2float(__float2half_rn(v));
}

// core/sampling.py::sample_bilinear(src, (u, v), half=True), RGB.
__device__ __forceinline__ void bilinear_half(const float* __restrict__ src,
                                              const TapsParams& p, float u, float v,
                                              float* out) {
  const float x = u * static_cast<float>(p.sw) - 0.5f;
  const float y = v * static_cast<float>(p.sh) - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x0 < 0.0f ? 0.0f : x - x0;
  const float fy = y0 < 0.0f ? 0.0f : y - y0;
  const int ix = re::floor_int(x0);
  const int iy = re::floor_int(y0);
  const int xa = re::clampi(ix, 0, p.sw - 1), xb = re::clampi(ix + 1, 0, p.sw - 1);
  const int ya = re::clampi(iy, 0, p.sh - 1), yb = re::clampi(iy + 1, 0, p.sh - 1);
  const float* r0 = src + static_cast<size_t>(ya) * p.sw * 3;
  const float* r1 = src + static_cast<size_t>(yb) * p.sw * 3;
  for (int c = 0; c < 3; ++c) {
    const float c00 = half_round(r0[3 * xa + c]), c01 = half_round(r0[3 * xb + c]);
    const float c10 = half_round(r1[3 * xa + c]), c11 = half_round(r1[3 * xb + c]);
    const float top = c00 + (c01 - c00) * fx;
    const float bot = c10 + (c11 - c10) * fx;
    out[c] = top + (bot - top) * fy;
  }
}

__global__ void __launch_bounds__(kBlock)
motion_blur_taps_kernel(const float* __restrict__ color, const float* __restrict__ velocity,
                        const float* __restrict__ tile, const float* __restrict__ src,
                        float* __restrict__ out, const TapsParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= p.w) return;
  const size_t pix = static_cast<size_t>(y) * p.w + x;
  const float u = scalar_div(static_cast<float>(x) + 0.5f, static_cast<float>(p.w),
                             p.inv_w, p.recip);
  float gy = static_cast<float>(y);
  if (p.row_offset != 0) gy = gy + static_cast<float>(p.row_offset);
  const float v = scalar_div(gy + 0.5f, static_cast<float>(p.sh), p.inv_fh, p.recip);
  const float* c = color + 3 * pix;
  const float vel0 = velocity[2 * pix], vel1 = velocity[2 * pix + 1];
  if (!(vel0 * vel0 + vel1 * vel1 > 1e-9f)) {  // a still pixel keeps its colour
    for (int k = 0; k < 3; ++k) out[3 * pix + k] = c[k];
    return;
  }
  const float vx = vel0 * p.intensity, vy = vel1 * p.intensity;
  const float* n = tile + 4 * (static_cast<size_t>((y + p.sy) % p.tile) * p.tile +
                               (x + p.sx) % p.tile);
  const float jx = vx * p.jitter * n[0], jy = vy * p.jitter * n[1];
  const float su = re::pmax(u + (jx - vx * 0.5f) * p.frame_speed, 0.0f);
  const float sv = re::pmax(v + (jy - vy * 0.5f) * p.frame_speed, 0.0f);
  const float eu = re::pmin(u + (jx + vx * 0.5f) * p.frame_speed, 1.0f);
  const float ev = re::pmin(v + (jy + vy * 0.5f) * p.frame_speed, 1.0f);
  float acc[3] = {c[0], c[1], c[2]};
  for (int i = 0; i <= p.samples; ++i) {
    const float t = static_cast<float>(i) / static_cast<float>(p.samples);
    float s[3];
    bilinear_half(src, p, su + (eu - su) * t, sv + (ev - sv) * t, s);
    for (int k = 0; k < 3; ++k) acc[k] = acc[k] + s[k];
  }
  for (int k = 0; k < 3; ++k) out[3 * pix + k] = scalar_div(acc[k], p.div, p.inv_div, p.recip);
}

}  // namespace

// ---- host entry points ----
// u_pos, u_neg, bin_pos, bin_neg: (h, w) float32; src: the padded
// (src_rows, src_cols, 4) float16 frame; acc: (h, w, 4) float32, written.
// Block row y reads source row row0 + y + dy, column col0 + x + dx.
// offsets (host): dy[dirs * steps] then dx[dirs * steps], int32; radii
// (host): lo[steps] then hi[steps], float32.
extern "C" int re_motion_blur(const float* u_pos, const float* u_neg,
                              const float* bin_pos, const float* bin_neg,
                              const void* src, float* acc, int h, int w,
                              int src_rows, int src_cols, int row0, int col0,
                              int dirs, int steps, const int* offsets,
                              const float* radii, void* stream) {
  const int cells = dirs * steps;
  if (h < 1 || w < 1 || dirs < 1 || steps < 1 ||
      reinterpret_cast<uintptr_t>(src) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(acc) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  for (int c = 0; c < cells; ++c) {  // every read inside the source
    const int dy = offsets[c];
    const int dx = offsets[cells + c];
    if (dy < -32768 || dy > 32767 || dx < -32768 || dx > 32767 ||
        row0 + dy < 0 || row0 + h - 1 + dy >= src_rows || col0 + dx < 0 ||
        col0 + w - 1 + dx >= src_cols) {
      return cudaErrorInvalidValue;
    }
  }
  MbParams p = {};
  p.w = w;
  p.sw = src_cols;
  p.row0 = row0;
  p.col0 = col0;
  p.dirs = dirs;
  p.steps = steps;
  const dim3 block(kBlock);
  const dim3 grid((w + kBlock - 1) / kBlock, h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int c0 = 0; c0 < cells; c0 += kCells) {
    p.c0 = c0;
    p.n = cells - c0 < kCells ? cells - c0 : kCells;
    p.first = c0 == 0;
    for (int i = 0; i < p.n; ++i) {
      const int c = c0 + i;
      p.dy[i] = static_cast<short>(offsets[c]);
      p.dx[i] = static_cast<short>(offsets[cells + c]);
      p.lo[i] = radii[c % steps];
      p.hi[i] = radii[steps + c % steps];
    }
    motion_blur_kernel<<<grid, block, 0, st>>>(
        u_pos, u_neg, bin_pos, bin_neg, static_cast<const Texel*>(src),
        reinterpret_cast<re::F4*>(acc), p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// color: the block's (h, w, 3) float32; velocity (h, w, 2); tile: the
// (tile, tile, 4) float32 blue noise; src: the (src_rows, src_cols, 3)
// float32 frame the taps read; out (h, w, 3), written. fparams (host):
// intensity, jitter, frame_speed, 1 / w, 1 / src_rows, samples + 2 and
// its reciprocal, each rounded to float32.
extern "C" int re_motion_blur_taps(const float* color, const float* velocity,
                                   const float* tile, const float* src, float* out,
                                   int h, int w, int src_rows, int src_cols,
                                   int row_offset, int tile_size, int sy, int sx,
                                   int samples, int recip, const float* fparams,
                                   void* stream) {
  if (h < 0 || w < 0 || src_rows < 1 || src_cols < 1 || tile_size < 1 || sy < 0 ||
      sx < 0 || samples < 1) {
    return cudaErrorInvalidValue;
  }
  if (h == 0 || w == 0) return cudaSuccess;
  TapsParams p;
  p.h = h;
  p.w = w;
  p.sh = src_rows;
  p.sw = src_cols;
  p.row_offset = row_offset;
  p.tile = tile_size;
  p.sy = sy;
  p.sx = sx;
  p.samples = samples;
  p.recip = recip;
  p.intensity = fparams[0];
  p.jitter = fparams[1];
  p.frame_speed = fparams[2];
  p.inv_w = fparams[3];
  p.inv_fh = fparams[4];
  p.div = fparams[5];
  p.inv_div = fparams[6];
  const dim3 block(kBlock);
  const dim3 grid((w + kBlock - 1) / kBlock, h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  motion_blur_taps_kernel<<<grid, block, 0, st>>>(color, velocity, tile, src, out, p);
  return cudaGetLastError();
}
