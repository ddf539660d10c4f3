// Z-buffer visibility: per pixel, the triangle of the nearest covered
// surface (strict z < zbuf, so the lowest id wins a tie) and its NDC z.
//
// Replaces ops/pallas/raster.py::_zscan_kernel (zscan_visibility), whose
// semantics are scene/rasterizer.py::_visibility's scan step. Each
// triangle is one row of 24 floats (ops/raster_kernel.py builds them):
//   0..8   edge coefficients c00,c01,c02,c10,...,c22 (A,B,C per edge)
//   9..11  A,B,C of sum(e_i w_i)   (w_pix numerator)
//   12..14 A,B,C of sum(e_i z_i)   (z numerator)
//   15..17 A,B,C of sum(e_i)       (weight normaliser)
//   18     sgn (+-1, the winding sign)
//   19..22 bbox ymin,ymax,xmin,xmax (+-inf unbounded; empty = culled)
//   23     unused
// At pixel centre (px, py) every plane is A * px + B * py + C. The pixel
// is covered when all three edges have the winding's sign, it lies in
// the bbox, w_pix = zw / se > 1e-6 and z_ndc = zc / zw lies in [-1, 1];
// the same guards (|se|, |zw| > 1e-20) as the TPU kernel.
//
// The TPU kernel walked the whole triangle list once per 64 x 512 block
// from an SMEM table, skipping a triangle whose bbox misses the block
// (`@pl.when(overlap)`), and ran scenes above 4096 triangles as
// min-combined batches. On the H100 a thread owns a pixel of an 8 x 32
// block; the block stages the table through shared memory in chunks of
// 128 triangles, in triangle order, and skips a triangle with one
// block-uniform test of its bbox against the block's pixel-centre
// bounds. One pass in triangle order with strict < gives the batches'
// result for any triangle count. Bound by operations: about 35 per
// (pixel, triangle whose bbox overlaps the pixel's block). Built with
// -fmad=false and IEEE division, so it equals zscan_plain bit for bit.
#include "common.cuh"

namespace {

constexpr int kNQ = 24;      // floats per triangle row
constexpr int kChunk = 128;  // triangles staged in shared memory at once
constexpr int kBX = 32;      // block: 32 columns x 8 rows
constexpr int kBY = 8;

__global__ void zscan_kernel(const float* __restrict__ tab, int n_tris, int h,
                             int w, float* __restrict__ zout,
                             int* __restrict__ idout) {
  RE_DYNAMIC_SHARED(float, s_tab);
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  // pixel-centre bounds of the whole block (past the frame edge too, as
  // the TPU kernel's padded blocks: the skip only gets more conservative)
  const float bx0 = static_cast<float>(blockIdx.x * kBX) + 0.5f;
  const float bx1 = static_cast<float>(blockIdx.x * kBX + kBX - 1) + 0.5f;
  const float by0 = static_cast<float>(blockIdx.y * kBY) + 0.5f;
  const float by1 = static_cast<float>(blockIdx.y * kBY + kBY - 1) + 0.5f;

  float zbest = __int_as_float(0x7f800000);  // +inf
  int best = -1;
  for (int base = 0; base < n_tris; base += kChunk) {
    const int n = min(kChunk, n_tris - base);
    re::block_sync();  // the previous chunk is read by every thread
    re::block_load(s_tab, tab + static_cast<size_t>(base) * kNQ, n * kNQ);
    for (int t = 0; t < n; ++t) {
      const float* q = s_tab + t * kNQ;
      const float ymin = q[19], ymax = q[20], xmin = q[21], xmax = q[22];
      if (!(ymin <= by1 && ymax >= by0 && xmin <= bx1 && xmax >= bx0)) {
        continue;  // uniform over the block
      }
      const float s = q[18];
      const float e0 = q[0] * px + q[1] * py + q[2];
      const float e1 = q[3] * px + q[4] * py + q[5];
      const float e2 = q[6] * px + q[7] * py + q[8];
      bool covered = e0 * s >= 0.0f && e1 * s >= 0.0f && e2 * s >= 0.0f;
      covered = covered && px >= xmin && px <= xmax && py >= ymin && py <= ymax;
      const float zw = q[9] * px + q[10] * py + q[11];
      const float zc = q[12] * px + q[13] * py + q[14];
      const float se = q[15] * px + q[16] * py + q[17];
      const float se_safe = fabsf(se) > 1e-20f ? se : 1e-20f;
      const float w_pix = zw / se_safe;
      const float z_ndc = zc / (fabsf(zw) > 1e-20f ? zw : 1e-20f);
      covered = covered && w_pix > 1e-6f && z_ndc >= -1.0f && z_ndc <= 1.0f;
      if (covered && z_ndc < zbest) {
        zbest = z_ndc;
        best = base + t;
      }
    }
  }
  if (x < w && y < h) {
    const size_t pix = static_cast<size_t>(y) * w + x;
    zout[pix] = zbest;
    idout[pix] = best;
  }
}

}  // namespace

// ---- host entry point ----
// tab (n_tris, 24) float32; out z (h, w) float32 (+inf where no
// triangle), ids (h, w) int32 (-1 where none).
extern "C" int re_zscan(const float* tab, float* zout, int* idout, int n_tris,
                        int h, int w, void* stream) {
  if (n_tris < 0 || h < 1 || w < 1) return cudaErrorInvalidValue;
  const dim3 block(kBX, kBY);
  const dim3 grid((w + kBX - 1) / kBX, (h + kBY - 1) / kBY);
  const size_t smem = static_cast<size_t>(kChunk) * kNQ * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  zscan_kernel<<<grid, block, smem, st>>>(tab, n_tris, h, w, zout, idout);
  return cudaGetLastError();
}
