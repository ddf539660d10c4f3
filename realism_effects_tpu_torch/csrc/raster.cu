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
//   23     unused (the staged row holds the triangle's id there)
// At pixel centre (px, py) every plane is A * px + B * py + C. The pixel
// is covered when all three edges have the winding's sign, it lies in
// the bbox, w_pix = zw / se > 1e-6 and z_ndc = zc / zw lies in [-1, 1];
// the same guards (|se|, |zw| > 1e-20) as the TPU kernel.
//
// The TPU kernel walked the whole triangle list once per 64 x 512 block
// from an SMEM table, skipping a triangle whose bbox misses the block
// (`@pl.when(overlap)`), and ran scenes above 4096 triangles as
// min-combined batches. The first H100 kernel did the same with a
// thread a pixel: every thread walked every triangle, and the skip test
// alone (4 shared loads, 4 compares, a branch a triangle, about 570 M
// warp instructions for the flagship's 734 triangles at 1080p) held it
// at 0.72 ms, issue-bound, where the scene needs about 3 triangles a
// pixel and the output write bounds it at 0.005 ms.
//
// Design: ordered per-block binning. A block of 16 x 16 threads owns a
// 16 x 32 tile, two pixels a thread. Its threads test the bboxes of
// consecutive triangles against the tile's pixel-centre bounds, one
// thread a triangle, a block-width at a time; re::block_compact (ballot,
// popc, a prefix over the warps) gives each overlapping triangle its
// slot in triangle order, and the triangle's row goes to shared memory.
// Every thread then walks only that list, each row read once for its
// two pixels. (A taller tile shares the bbox tests over more pixels and
// lengthens each list; two pixels a thread balance the two on the
// flagship's table and on a tie-heavy one of a few thousand triangles.)
// A tile whose list outgrows kCap works in rounds (compact to capacity,
// walk, go on from the next triangle), so nothing is dropped or
// reordered: one pass in triangle order with strict < for any triangle
// count, the batches' result. Built with -fmad=false and IEEE division,
// so it equals zscan_plain bit for bit.
//
// The alpha variant (re_zscan_alpha) is the same walk with the two tests
// of _visibility's stochastic-alpha scan step, for one depth-peel pass:
// - the material-alpha law of `GBufferMaterial.js:57-79`: on the first
//   still frame (cnmf < 0.5) a hard cut a >= 0.5; later a pixel keeps
//   the triangle where a >= 0.9999 or dither < a + (a_step - a) * ramp,
//   a_step = (a >= 0.5), ramp = 1 / (cnmf * 0.1 + 1). XLA's CPU backend
//   contracts both sums into fused multiply-adds, so they are the two
//   explicit fmaf below (computed once a triangle, when it is staged);
// - exclusion of the earlier peels' winners: the triangle drops out of
//   a pixel whose winner it was in any of the n_excl earlier passes (by
//   id, so a triangle that ties an excluded one's z is still a candidate).
// Both tests only remove candidates, so they run after the cheap ones,
// where a triangle would otherwise become the pixel's nearest.
#include "common.cuh"

namespace {

constexpr int kNQ = 24;    // floats per triangle row
constexpr int kBX = 16;    // block: 16 x 16 threads
constexpr int kBY = 16;
constexpr int kPY = 2;     // pixels a thread, kBY rows apart: a 16 x 32 tile
constexpr int kCap = 256;  // triangles a round holds in shared memory

// A staged row: the table's 23 floats, the id in float 23 and, in the
// alpha variant, the triangle's soft threshold (24) and its pass-all
// flag (25: a >= 0.5 on a hard-cut frame, a >= 0.9999 after).
template <bool kAlpha>
constexpr int kRowFloats = kAlpha ? kNQ + 2 : kNQ;

template <bool kAlpha>
__global__ void zscan_kernel(const float* __restrict__ tab, int n_tris, int h,
                             int w, float* __restrict__ zout,
                             int* __restrict__ idout,
                             const float* __restrict__ alpha,
                             const float* __restrict__ dither,
                             const int* __restrict__ excl, int n_excl,
                             float cnmf) {
  constexpr int kRow = kRowFloats<kAlpha>;
  RE_DYNAMIC_SHARED(float, s_rows);  // kCap rows of kRow floats
  const int tile_x = blockIdx.x * kBX;
  const int tile_y = blockIdx.y * kBY * kPY;
  const int x = tile_x + threadIdx.x;
  const float px = static_cast<float>(x) + 0.5f;
  // pixel-centre bounds of the whole tile (past the frame edge too, as
  // the TPU kernel's padded blocks: the skip only gets more conservative)
  const float bx0 = static_cast<float>(tile_x) + 0.5f;
  const float bx1 = static_cast<float>(tile_x + kBX - 1) + 0.5f;
  const float by0 = static_cast<float>(tile_y) + 0.5f;
  const float by1 = static_cast<float>(tile_y + kBY * kPY - 1) + 0.5f;
  const bool hard = cnmf < 0.5f;
  const float ramp = 1.0f / fmaf(cnmf, 0.1f, 1.0f);
  const auto overlaps = [&](int t) {
    const float* q = tab + static_cast<size_t>(t) * kNQ;
    return q[19] <= by1 && q[20] >= by0 && q[21] <= bx1 && q[22] >= bx0;
  };
  const auto stage = [&](int slot, int t) {
    const float* q = tab + static_cast<size_t>(t) * kNQ;
    float* r = s_rows + slot * kRow;
#pragma unroll
    for (int j = 0; j < kNQ - 1; ++j) r[j] = q[j];
    r[kNQ - 1] = __int_as_float(t);
    if constexpr (kAlpha) {
      const float a = alpha[t];
      const float a_step = a >= 0.5f ? 1.0f : 0.0f;
      r[kNQ] = fmaf(a_step - a, ramp, a);
      r[kNQ + 1] = (hard ? a >= 0.5f : a >= 0.9999f) ? 1.0f : 0.0f;
    }
  };

  float py[kPY], zbest[kPY], dth[kPY];
  int best[kPY];
  size_t pix[kPY];
  bool live[kPY];  // in the frame
#pragma unroll
  for (int i = 0; i < kPY; ++i) {
    const int y = tile_y + threadIdx.y + i * kBY;
    py[i] = static_cast<float>(y) + 0.5f;
    zbest[i] = __int_as_float(0x7f800000);  // +inf
    best[i] = -1;
    pix[i] = static_cast<size_t>(y) * w + x;
    live[i] = x < w && y < h;
    dth[i] = 0.0f;
    if constexpr (kAlpha) {
      if (live[i]) dth[i] = dither[pix[i]];
    }
  }
  const size_t plane = static_cast<size_t>(h) * w;
  for (int start = 0; start < n_tris;) {
    int next;
    const int n = re::block_compact(start, n_tris, kCap, overlaps, stage, next);
    for (int t = 0; t < n; ++t) {
      const float* q = s_rows + t * kRow;
      const float ymin = q[19], ymax = q[20], xmin = q[21], xmax = q[22];
      const float s = q[18];
      const int id = static_cast<int>(__float_as_uint(q[kNQ - 1]));
#pragma unroll
      for (int i = 0; i < kPY; ++i) {
        const float e0 = q[0] * px + q[1] * py[i] + q[2];
        const float e1 = q[3] * px + q[4] * py[i] + q[5];
        const float e2 = q[6] * px + q[7] * py[i] + q[8];
        bool covered = e0 * s >= 0.0f && e1 * s >= 0.0f && e2 * s >= 0.0f;
        covered = covered && px >= xmin && px <= xmax && py[i] >= ymin &&
                  py[i] <= ymax;
        const float zw = q[9] * px + q[10] * py[i] + q[11];
        const float zc = q[12] * px + q[13] * py[i] + q[14];
        const float se = q[15] * px + q[16] * py[i] + q[17];
        const float se_safe = fabsf(se) > 1e-20f ? se : 1e-20f;
        const float w_pix = zw / se_safe;
        const float z_ndc = zc / (fabsf(zw) > 1e-20f ? zw : 1e-20f);
        covered = covered && w_pix > 1e-6f && z_ndc >= -1.0f && z_ndc <= 1.0f;
        if constexpr (kAlpha) {
          if (covered && z_ndc < zbest[i]) {
            covered = live[i] &&
                      (q[kNQ + 1] != 0.0f || (!hard && dth[i] < q[kNQ]));
            for (int p = 0; p < n_excl && covered; ++p) {
              covered = excl[p * plane + pix[i]] != id;
            }
          }
        }
        if (covered && z_ndc < zbest[i]) {
          zbest[i] = z_ndc;
          best[i] = id;
        }
      }
    }
    start = next;
  }
#pragma unroll
  for (int i = 0; i < kPY; ++i) {
    if (live[i]) {
      zout[pix[i]] = zbest[i];
      idout[pix[i]] = best[i];
    }
  }
}

template <bool kAlpha>
int launch_zscan(const float* tab, float* zout, int* idout, int n_tris, int h,
                 int w, const float* alpha, const float* dither,
                 const int* excl, int n_excl, float cnmf, void* stream) {
  if (n_tris < 0 || h < 1 || w < 1 || n_excl < 0) return cudaErrorInvalidValue;
  const dim3 block(kBX, kBY);
  const dim3 grid((w + kBX - 1) / kBX, (h + kBY * kPY - 1) / (kBY * kPY));
  const size_t smem =
      static_cast<size_t>(kCap) * kRowFloats<kAlpha> * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  zscan_kernel<kAlpha><<<grid, block, smem, st>>>(
      tab, n_tris, h, w, zout, idout, alpha, dither, excl, n_excl, cnmf);
  return cudaGetLastError();
}

}  // namespace

// ---- host entry points ----
// tab (n_tris, 24) float32; out z (h, w) float32 (+inf where no
// triangle), ids (h, w) int32 (-1 where none).
extern "C" int re_zscan(const float* tab, float* zout, int* idout, int n_tris,
                        int h, int w, void* stream) {
  return launch_zscan<false>(tab, zout, idout, n_tris, h, w, nullptr, nullptr,
                             nullptr, 0, 0.0f, stream);
}

// One peel pass of the stochastic-alpha scan: as re_zscan, with alpha
// (n_tris,) float32 material alpha, dither (h, w) float32, excl
// (n_excl, h, w) int32 winner ids of the earlier passes (none when
// n_excl is 0) and *cnmf (a host float) the camera's still-frame count.
extern "C" int re_zscan_alpha(const float* tab, const float* alpha,
                              const float* dither, const int* excl,
                              float* zout, int* idout, int n_tris, int h,
                              int w, int n_excl, const float* cnmf,
                              void* stream) {
  if (cnmf == nullptr) return cudaErrorInvalidValue;
  return launch_zscan<true>(tab, zout, idout, n_tris, h, w, alpha, dither,
                            excl, n_excl, *cnmf, stream);
}
