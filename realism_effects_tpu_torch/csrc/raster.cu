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
// The alpha variant (re_zscan_peels) runs every depth-peel pass of
// _visibility's stochastic-alpha scan in one walk. Pass p excludes the
// raw winners of passes 0 .. p-1 by id, and every pass applies the same
// coverage test and the same material-alpha law, so pass p's winner is
// the (p+1)-th smallest (z_ndc, id) among the triangles that pass
// (strict <, the first triangle wins a tie: the lexicographic minimum;
// -0 and +0 compare equal, so the id decides). Each pixel keeps its P
// smallest (z, id) sorted in registers and inserts a candidate that
// passes coverage and the law below the P-th; the compares are
// lexicographic, so the result does not depend on the walk's order. The
// law is that of `GBufferMaterial.js:57-79`: on the first still frame
// (cnmf < 0.5) a hard cut a >= 0.5; later a pixel keeps the triangle
// where a >= 0.9999 or dither < a + (a_step - a) * ramp, a_step =
// (a >= 0.5), ramp = 1 / (cnmf * 0.1 + 1). XLA's CPU backend contracts
// both sums into fused multiply-adds, so they are the two explicit fmaf
// of the prep kernel, which computes each triangle's soft threshold and
// pass-all flag once a launch. A P above kMaxP runs as chunks of at most
// kMaxP planes; a later chunk admits only a (z, id) above its floor, the
// previous chunk's last plane, so it reads 8 B a pixel and no exclusion
// planes. The P planes equal P passes of the per-pass scan bit for bit.
//
// What bounds it: the output, 8 B a pixel a plane (plus 4 B of dither),
// which at 3840 x 2160 and P = 3 takes 0.069 ms at 3.35 TB/s. Measured
// on the H100 at that raster, the per-tile bbox phase, and not the walk,
// held a first fused version (the opaque kernel's 16 x 32 tile and
// block_compact): each round a warp loads 32 rows 96 B apart and the
// block waits at two barriers, three rounds for 748 triangles. So: the
// prep kernel also writes each bbox as 16 aligned bytes (a warp's loads
// contiguous); re::block_compact_wide tests four block-widths a round
// (one round up to 1024 triangles); the tile is 32 x 32 (a block of
// 32 x 8 threads, four pixels a thread, half the tiles); three blocks an
// SM (a register cap of 80). Where a triangle misses a pixel's edges or
// bbox, the division of the depth test is skipped (a branch: a warp
// whose pixels all miss skips it). The dither is read through its
// strides, so a view needs no copy.
#include "common.cuh"

namespace {

constexpr int kNQ = 24;    // floats per triangle row
constexpr int kBX = 16;    // block: 16 x 16 threads
constexpr int kBY = 16;
constexpr int kPY = 2;     // pixels a thread, kBY rows apart: a 16 x 32 tile
constexpr int kCap = 256;  // triangles a round holds in shared memory
// The alpha variant's tile: a block of kPeelBX x kPeelBY threads,
// kPeelPY pixels a thread kPeelBY rows apart; its bbox phase tests
// kPeelK block-widths of triangles a round; kPeelMinBlocks resident
// blocks an SM (a register cap); kMaxP peel planes a launch.
constexpr int kPeelBX = 32;
constexpr int kPeelBY = 8;
constexpr int kPeelPY = 4;  // a 32 x 32 tile
constexpr int kPeelK = 4;
constexpr int kPeelMinBlocks = 3;
constexpr int kMaxP = 4;
// The alpha variant's staged row: the table's 23 floats, the id in
// float 23, the triangle's soft threshold (24) and pass-all flag (25).
constexpr int kPeelRow = kNQ + 2;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// (za, ia) before (zb, ib): z first, the lower id on a tie.
__device__ __forceinline__ bool before(float za, int ia, float zb, int ib) {
  return za < zb || (za == zb && ia < ib);
}

__global__ void zscan_kernel(const float* __restrict__ tab, int n_tris, int h,
                             int w, float* __restrict__ zout,
                             int* __restrict__ idout) {
  RE_DYNAMIC_SHARED(float, s_rows);  // kCap rows of kNQ floats
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
  const auto overlaps = [&](int t) {
    const float* q = tab + static_cast<size_t>(t) * kNQ;
    return q[19] <= by1 && q[20] >= by0 && q[21] <= bx1 && q[22] >= bx0;
  };
  const auto stage = [&](int slot, int t) {
    const float* q = tab + static_cast<size_t>(t) * kNQ;
    float* r = s_rows + slot * kNQ;
#pragma unroll
    for (int j = 0; j < kNQ - 1; ++j) r[j] = q[j];
    r[kNQ - 1] = __int_as_float(t);
  };

  float py[kPY], zbest[kPY];
  int best[kPY];
  size_t pix[kPY];
  bool live[kPY];  // in the frame
#pragma unroll
  for (int i = 0; i < kPY; ++i) {
    const int y = tile_y + threadIdx.y + i * kBY;
    py[i] = static_cast<float>(y) + 0.5f;
    zbest[i] = pos_inf();
    best[i] = -1;
    pix[i] = static_cast<size_t>(y) * w + x;
    live[i] = x < w && y < h;
  }
  for (int start = 0; start < n_tris;) {
    int next;
    const int n = re::block_compact(start, n_tris, kCap, overlaps, stage, next);
    for (int t = 0; t < n; ++t) {
      const float* q = s_rows + t * kNQ;
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

// The alpha variant's per-triangle pass, once a launch: prep[8 t ..
// 8 t + 3] the triangle's bbox (ymin, ymax, xmin, xmax, 16-byte aligned,
// so a tile's bbox phase reads 16 B a triangle in one load, a warp's
// loads contiguous); prep[8 t + 4] the law's soft threshold (the
// triangle passes where dither < it; -inf on a hard-cut frame);
// prep[8 t + 5] 1 where the triangle passes whatever the dither (a >= 0.5
// on a hard-cut frame, a >= 0.9999 after), else 0.
__global__ void zscan_prep_kernel(const float* __restrict__ tab,
                                  const float* __restrict__ alpha, int n_tris,
                                  float cnmf, float* __restrict__ prep) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tris) return;
  const float* q = tab + static_cast<size_t>(t) * kNQ;
  const bool hard = cnmf < 0.5f;
  const float ramp = 1.0f / fmaf(cnmf, 0.1f, 1.0f);
  const float a = alpha[t];
  const float a_step = a >= 0.5f ? 1.0f : 0.0f;
  re::F4* out = reinterpret_cast<re::F4*>(prep) + 2 * t;
  out[0] = re::F4{{q[19], q[20], q[21], q[22]}};
  out[1] = re::F4{{hard ? -pos_inf() : fmaf(a_step - a, ramp, a),
                   (hard ? a >= 0.5f : a >= 0.9999f) ? 1.0f : 0.0f, 0.0f, 0.0f}};
}

// kP peel planes of the alpha variant: per pixel the kP smallest (z, id)
// after the floor (zfloor, idfloor; none when null) among the triangles
// that cover it and pass the law, written to planes 0 .. kP-1 of
// zout / idout (+inf and -1 past the last). dither is read at
// y * dsy + x * dsx.
template <int kP>
__global__ void __launch_bounds__(kPeelBX * kPeelBY, kPeelMinBlocks)
zscan_peels_kernel(const float* __restrict__ tab,
                   const float* __restrict__ prep, int n_tris, int h, int w,
                   const float* __restrict__ dither, int dsy, int dsx,
                   const float* __restrict__ zfloor,
                   const int* __restrict__ idfloor, float* __restrict__ zout,
                   int* __restrict__ idout) {
  RE_DYNAMIC_SHARED(float, s_rows);  // kCap rows of kPeelRow floats
  const int tile_x = blockIdx.x * kPeelBX;
  const int tile_y = blockIdx.y * kPeelBY * kPeelPY;
  const int x = tile_x + threadIdx.x;
  const float px = static_cast<float>(x) + 0.5f;
  const float bx0 = static_cast<float>(tile_x) + 0.5f;
  const float bx1 = static_cast<float>(tile_x + kPeelBX - 1) + 0.5f;
  const float by0 = static_cast<float>(tile_y) + 0.5f;
  const float by1 = static_cast<float>(tile_y + kPeelBY * kPeelPY - 1) + 0.5f;
  const re::F4* boxes = reinterpret_cast<const re::F4*>(prep);
  const auto overlaps = [&](int t) {
    const re::F4 b = boxes[2 * t];
    return b.v[0] <= by1 && b.v[1] >= by0 && b.v[2] <= bx1 && b.v[3] >= bx0;
  };
  const auto stage = [&](int slot, int t) {
    const float* q = tab + static_cast<size_t>(t) * kNQ;
    float* r = s_rows + slot * kPeelRow;
#pragma unroll
    for (int j = 0; j < kNQ - 1; ++j) r[j] = q[j];
    r[kNQ - 1] = __int_as_float(t);
    r[kNQ] = prep[8 * t + 4];
    r[kNQ + 1] = prep[8 * t + 5];
  };

  float py[kPeelPY], dth[kPeelPY], zf[kPeelPY], zl[kPeelPY][kP];
  int idf[kPeelPY], il[kPeelPY][kP];
  size_t pix[kPeelPY];
  bool live[kPeelPY];  // in the frame
#pragma unroll
  for (int i = 0; i < kPeelPY; ++i) {
    const int y = tile_y + threadIdx.y + i * kPeelBY;
    py[i] = static_cast<float>(y) + 0.5f;
    pix[i] = static_cast<size_t>(y) * w + x;
    live[i] = x < w && y < h;
    dth[i] = live[i] ? dither[static_cast<size_t>(y) * dsy + static_cast<size_t>(x) * dsx]
                     : 0.0f;
    const bool has_floor = live[i] && zfloor != nullptr;
    zf[i] = has_floor ? zfloor[pix[i]] : -pos_inf();
    idf[i] = has_floor ? idfloor[pix[i]] : -1;
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      zl[i][k] = pos_inf();
      il[i][k] = -1;
    }
  }
  for (int start = 0; start < n_tris;) {
    int next;
    const int n = re::block_compact_wide<kPeelK>(start, n_tris, kCap, overlaps,
                                                 stage, next);
    for (int t = 0; t < n; ++t) {
      const float* q = s_rows + t * kPeelRow;
      const float ymin = q[19], ymax = q[20], xmin = q[21], xmax = q[22];
      const float s = q[18];
      const int id = static_cast<int>(__float_as_uint(q[kNQ - 1]));
      const float thr = q[kNQ];
      const bool pass_all = q[kNQ + 1] != 0.0f;
#pragma unroll
      for (int i = 0; i < kPeelPY; ++i) {
        const float e0 = q[0] * px + q[1] * py[i] + q[2];
        const float e1 = q[3] * px + q[4] * py[i] + q[5];
        const float e2 = q[6] * px + q[7] * py[i] + q[8];
        if (!(e0 * s >= 0.0f && e1 * s >= 0.0f && e2 * s >= 0.0f && px >= xmin &&
              px <= xmax && py[i] >= ymin && py[i] <= ymax)) {
          continue;
        }
        const float zw = q[9] * px + q[10] * py[i] + q[11];
        const float zc = q[12] * px + q[13] * py[i] + q[14];
        const float se = q[15] * px + q[16] * py[i] + q[17];
        const float se_safe = fabsf(se) > 1e-20f ? se : 1e-20f;
        const float w_pix = zw / se_safe;
        float z = zc / (fabsf(zw) > 1e-20f ? zw : 1e-20f);
        if (!(w_pix > 1e-6f && z >= -1.0f && z <= 1.0f) ||
            !before(z, id, zl[i][kP - 1], il[i][kP - 1]) ||
            !before(zf[i], idf[i], z, id) || !(pass_all || dth[i] < thr)) {
          continue;
        }
        int c = id;  // insert (z, c) in order; the last entry drops out
#pragma unroll
        for (int k = 0; k < kP; ++k) {
          const bool lt = before(z, c, zl[i][k], il[i][k]);
          const float zk = zl[i][k];
          const int ik = il[i][k];
          zl[i][k] = lt ? z : zk;
          il[i][k] = lt ? c : ik;
          z = lt ? zk : z;
          c = lt ? ik : c;
        }
      }
    }
    start = next;
  }
  const size_t plane = static_cast<size_t>(h) * w;
#pragma unroll
  for (int i = 0; i < kPeelPY; ++i) {
    if (live[i]) {
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        zout[k * plane + pix[i]] = zl[i][k];
        idout[k * plane + pix[i]] = il[i][k];
      }
    }
  }
}

template <int kP>
void launch_peels(const float* tab, const float* prep, int n_tris, int h, int w,
                  const float* dither, int dsy, int dsx, const float* zfloor,
                  const int* idfloor, float* zout, int* idout, cudaStream_t st) {
  const dim3 grid((w + kPeelBX - 1) / kPeelBX,
                  (h + kPeelBY * kPeelPY - 1) / (kPeelBY * kPeelPY));
  const dim3 block(kPeelBX, kPeelBY);
  const size_t smem = static_cast<size_t>(kCap) * kPeelRow * sizeof(float);
  zscan_peels_kernel<kP><<<grid, block, smem, st>>>(
      tab, prep, n_tris, h, w, dither, dsy, dsx, zfloor, idfloor, zout, idout);
}

}  // namespace

// ---- host entry points ----
// tab (n_tris, 24) float32; out z (h, w) float32 (+inf where no
// triangle), ids (h, w) int32 (-1 where none).
extern "C" int re_zscan(const float* tab, float* zout, int* idout, int n_tris,
                        int h, int w, void* stream) {
  if (n_tris < 0 || h < 1 || w < 1) return cudaErrorInvalidValue;
  const dim3 block(kBX, kBY);
  const dim3 grid((w + kBX - 1) / kBX, (h + kBY * kPY - 1) / (kBY * kPY));
  const size_t smem = static_cast<size_t>(kCap) * kNQ * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  zscan_kernel<<<grid, block, smem, st>>>(
      tab, n_tris, h, w, zout, idout);
  return cudaGetLastError();
}

// Every peel pass of the stochastic-alpha scan: as re_zscan, with alpha
// (n_tris,) float32 material alpha, dither float32 read at y * dsy +
// x * dsx (elements) and *cnmf (a host float) the camera's still-frame
// count; prep (n_tris, 8) float32 scratch, 16-byte aligned; out z and
// ids (passes, h, w), plane p the winner of pass p.
extern "C" int re_zscan_peels(const float* tab, const float* alpha,
                              const float* dither, float* prep, float* zout,
                              int* idout, int n_tris, int h, int w, int dsy,
                              int dsx, int passes, const float* cnmf,
                              void* stream) {
  if (n_tris < 0 || h < 1 || w < 1 || dsy < 0 || dsx < 0 || passes < 1 ||
      cnmf == nullptr) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_tris > 0) {
    zscan_prep_kernel<<<(n_tris + 255) / 256, 256, 0, st>>>(tab, alpha, n_tris,
                                                            *cnmf, prep);
  }
  const size_t plane = static_cast<size_t>(h) * w;
  for (int p0 = 0; p0 < passes; p0 += kMaxP) {
    const float* zf = p0 > 0 ? zout + (p0 - 1) * plane : nullptr;
    const int* idf = p0 > 0 ? idout + (p0 - 1) * plane : nullptr;
    float* zo = zout + p0 * plane;
    int* io = idout + p0 * plane;
    const auto run = [&](auto launch) {
      launch(tab, prep, n_tris, h, w, dither, dsy, dsx, zf, idf, zo, io, st);
    };
    switch (passes - p0 < kMaxP ? passes - p0 : kMaxP) {
      case 1: run(launch_peels<1>); break;
      case 2: run(launch_peels<2>); break;
      case 3: run(launch_peels<3>); break;
      default: run(launch_peels<4>); break;
    }
    const int err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}
