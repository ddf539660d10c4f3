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

}  // namespace

// ---- host entry point ----
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
