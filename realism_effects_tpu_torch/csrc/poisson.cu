// One whole Poisson-denoise pass (`poisson_denoise.frag:94-190`) over a
// packed bundle (H, W, Cb): [depth f32 | oct-half2x16 normal | rough f32
// | per slot: one half2x16 (value, alpha) if scalar, else (r, g) and
// (b, a) half2x16]. Output (H, W, 4 * n_tex): rgba per slot.
//
// Replaces ops/pallas/poisson.py::_poisson_kernel (poisson_pass_fused).
// Semantics kept: flatness from forward differences of the DECODED
// normal, zero at the frame edge; the 8 Poisson offsets rotated by the
// blue-noise angle in uv with the global aspect; nearest taps clamped to
// the frame; exact float16 decode; packed 0.0 normals decode to (0,0,0);
// x^e as exp(log(x) * e); background pixels pass the raw input through.
// The TPU kernel's tap-window clamp is dropped: its windows are the
// bound of the tap reach, so it never binds (the tests check this).
// A row block of a larger frame (the row-sharded route: a shard extended
// by halo rows) passes the global row of its first row, row0, and the
// global resolution (wg, hg): the uv, the flatness's bottom edge and the
// taps' frame clamp are the global frame's, a tap row is then re-based
// by -row0 and held to the block, and the host rolls the noise by row0.
// With row0 = 0 and (wg, hg) = (w, h) this is the unsharded pass.
//
// On the H100 the pass is bound by instruction issue, not bytes: the
// first kernel (a thread a pixel, direct loads) recomputed each tap's
// texel-only values, a normal decode (a square root, three divisions)
// and per slot three logs and a luminance pow, for each of the 8 taps,
// so about 160 accurate libm calls a two-slot pixel, while each texel is
// tapped about 8 times at radius 3. Design: the values that depend on
// the texel only (depth, decoded normal, roughness, per slot
// log(max(rgb, 0) + 1) and its luminance8) are computed once a texel
// into shared memory, as structure-of-arrays floats, for the block's
// 32 x 8 tile plus a halo of the tap reach (from the radius, the
// offsets and the aspect, at most kMaxHalo). A tap outside the staged
// region computes the same function of the same bits directly. The tap
// loop keeps the work that depends on the pixel: the edge weights' exp,
// the specular factor, the disocclusion pow, the luma exp, the age blend.
#include <math.h>

#include "common.cuh"

namespace {

using re::clampi;
using re::pow_el;

constexpr int kMaxTex = 4;
constexpr float kPi2 = 6.2831855f;  // float32(2 * pi)
constexpr int kBX = 32;             // block: 32 columns x 8 rows
constexpr int kBY = 8;
constexpr int kMaxHalo = 8;         // staged texels beyond the tile, a side

struct PoissonParams {
  float radius, age_e, luma_phi, depth_phi, normal_phi, roughness_phi,
      specular_phi;
  float inv_w, inv_h, wg, hg;  // of the global frame
  float offx[8];  // POISSON8[k][0] / W
  float offy[8];  // POISSON8[k][1] / H
  int sy, sx;     // blue-noise shift of this pass (rolled by row0)
  int row0;       // global row of the block's row 0
  int hgi;        // global rows
  int cb;         // bundle channels
  int hx, hy;     // staged halo: columns, rows
  int slot_ch[kMaxTex];
  int scalar[kMaxTex];
  int spec[kMaxTex];
};

__device__ __forceinline__ float luminance8(float r, float g, float b) {
  return pow_el(fmaxf(r * 0.2125f + g * 0.7154f + b * 0.0721f, 0.0f), 0.125f);
}

__device__ __forceinline__ void slot_rgba(const float* t, int ch, bool scalar,
                                          float* rgb, float& alpha) {
  if (scalar) {
    float v;
    re::unpack_half2(t[ch], v, alpha);
    rgb[0] = v;
    rgb[1] = v;
    rgb[2] = v;
  } else {
    re::unpack_half2(t[ch], rgb[0], rgb[1]);
    re::unpack_half2(t[ch + 1], rgb[2], alpha);
  }
}

// The texel-only values of bundle texel t, texel_floats(NT) of them:
// v[0] depth, v[1..3] the decoded normal, v[4] roughness, then per slot
// s v[5 + 4s ..] the three log(max(raw, 0) + 1) and their luminance8.
__host__ __device__ constexpr int texel_floats(int nt) { return 5 + 4 * nt; }

template <int NT>
__device__ __forceinline__ void texel_values(const float* t,
                                             const PoissonParams& p,
                                             float* v) {
  v[0] = t[0];
  re::unpack_normal(t[1], v[1], v[2], v[3]);
  v[4] = t[2];
#pragma unroll
  for (int s = 0; s < NT; ++s) {
    float traw[3], ta;
    slot_rgba(t, p.slot_ch[s], p.scalar[s] != 0, traw, ta);
    float* tr = v + 5 + 4 * s;
    if (p.scalar[s]) {  // three equal channels: one log
      tr[0] = logf(fmaxf(traw[0], 0.0f) + 1.0f);
      tr[1] = tr[0];
      tr[2] = tr[0];
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) tr[i] = logf(fmaxf(traw[i], 0.0f) + 1.0f);
    }
    tr[3] = luminance8(tr[0], tr[1], tr[2]);
  }
}

template <int NT>
__global__ void __launch_bounds__(kBX * kBY)
poisson_kernel(const float* __restrict__ bundle, const float* __restrict__ tile,
               float* __restrict__ out, int h, int w, const PoissonParams p) {
  constexpr int kV = texel_floats(NT);
  RE_DYNAMIC_SHARED(float, s_tex);  // kV planes of tw x th texels
  const int cb = p.cb;
  const int gx0 = blockIdx.x * kBX - p.hx;  // staged region's origin
  const int gy0 = blockIdx.y * kBY - p.hy;
  const int tw = kBX + 2 * p.hx;
  const int th = kBY + 2 * p.hy;
  const int tn = tw * th;
  re::block_fill(tn, [&](int i) {
    const int gy = gy0 + i / tw;
    const int gx = gx0 + i % tw;
    if (gx < 0 || gx >= w || gy < 0 || gy >= h) return;
    float v[kV];
    texel_values<NT>(bundle + (static_cast<size_t>(gy) * w + gx) * cb, p, v);
#pragma unroll
    for (int j = 0; j < kV; ++j) s_tex[j * tn + i] = v[j];
  });

  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= w || y >= h) return;
  // staged index of an in-frame texel (the tile's own, and its right and
  // down neighbours, are always staged: the halo is at least 1)
  const auto staged = [&](int iy, int ix) { return (iy - gy0) * tw + (ix - gx0); };
  const int ic = staged(y, x);
  const float d_c = s_tex[ic];
  const float ncx = s_tex[tn + ic], ncy = s_tex[2 * tn + ic], ncz = s_tex[3 * tn + ic];
  const float rough_c = s_tex[4 * tn + ic];

  // flatness from fwidth of the decoded normal (forward differences,
  // zero at the frame edge)
  const int ir = staged(y, min(x + 1, w - 1));
  const int id = staged(min(y + 1, h - 1), x);
  const float right_ok = x < w - 1 ? 1.0f : 0.0f;
  const int yg = y + p.row0;
  const float down_ok = yg < p.hgi - 1 ? 1.0f : 0.0f;
  float fw2 = 0.0f;
  {
    const float c0[3] = {ncx, ncy, ncz};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float cr = s_tex[(1 + i) * tn + ir];
      const float cd = s_tex[(1 + i) * tn + id];
      const float fw = fabsf(cr - c0[i]) * right_ok + fabsf(cd - c0[i]) * down_ok;
      fw2 = fw2 + fw * fw;
    }
  }
  float flatness = 1.0f - fminf(sqrtf(fw2), 1.0f);
  flatness = flatness * flatness * 0.75f + 0.25f;

  const float angle = tile[(((y + p.sy) & 127) * 128 + ((x + p.sx) & 127)) * 4] * kPi2;
  const float s_ = sinf(angle);
  const float c_ = cosf(angle);
  const float rscale = p.radius * flatness;
  const float uvx = (static_cast<float>(x) + 0.5f) * p.inv_w;
  const float uvy = (static_cast<float>(yg) + 0.5f) * p.inv_h;
  // a tap row clamped to the frame, then re-based onto the block and held
  // to it: clamp(clamp(v, 0, hg - 1) - row0, 0, h - 1) as one clamp of
  // v - row0 (the two ranges overlap: the block holds its halo's rows)
  const int iy_lo = max(-p.row0, 0);
  const int iy_hi = min(p.hgi - 1 - p.row0, h - 1);

  // center state per slot
  const float* center = bundle + (static_cast<size_t>(y) * w + x) * cb;
  float raw[NT][3], alpha[NT], lum[NT], age[NT], acc[NT][3], total[NT];
#pragma unroll
  for (int s = 0; s < NT; ++s) {
    slot_rgba(center, p.slot_ch[s], p.scalar[s] != 0, raw[s], alpha[s]);
#pragma unroll
    for (int i = 0; i < 3; ++i) acc[s][i] = logf(raw[s][i] * 1.0003f + 1.0f);
    lum[s] = luminance8(acc[s][0], acc[s][1], acc[s][2]);
    age[s] = 1.0f / pow_el(alpha[s] + 1.0f, p.age_e);
    total[s] = 1.0f;
  }
  const float glossiness = fmaxf(0.0f, 4.0f * (1.0f - rough_c / 0.25f));
  const float specular_factor = expf(-glossiness * p.specular_phi);

  for (int k = 0; k < 8; ++k) {
    const float ox = (c_ * p.offx[k] + s_ * p.offy[k]) * rscale;
    const float oy = (-s_ * p.offx[k] + c_ * p.offy[k]) * rscale;
    const int ixt = clampi(static_cast<int>(floorf((uvx + ox) * p.wg)), 0, w - 1);
    const int iyt =
        clampi(static_cast<int>(floorf((uvy + oy) * p.hg)) - p.row0, iy_lo, iy_hi);
    float v[kV];
    const int sx = ixt - gx0;
    const int sy = iyt - gy0;
    if (sx >= 0 && sx < tw && sy >= 0 && sy < th) {
      const float* q = s_tex + sy * tw + sx;
#pragma unroll
      for (int j = 0; j < kV; ++j) v[j] = q[j * tn];
    } else {
      texel_values<NT>(bundle + (static_cast<size_t>(iyt) * w + ixt) * cb, p, v);
    }
    const float n_depth = v[0];
    const float ndot = ncx * v[1] + ncy * v[2] + ncz * v[3];
    const float normal_diff = 1.0f - fmaxf(ndot, 0.0f);
    const float depth_diff = 10000.0f * fabsf(d_c - n_depth);
    const float rough_diff = fabsf(rough_c - v[4]);
    float w_basic = expf(-normal_diff * p.normal_phi - depth_diff * p.depth_phi -
                         rough_diff * p.roughness_phi);
    w_basic = n_depth >= 1.0f ? 0.0f : w_basic;
#pragma unroll
    for (int s = 0; s < NT; ++s) {
      const float* tr = v + 5 + 4 * s;
      float wgt = w_basic * (p.spec[s] ? specular_factor : 1.0f);
      const float disoccl_w = pow_el(fmaxf(wgt, 1e-20f), 0.1f);
      const float luma_diff = fminf(fabsf(lum[s] - tr[3]), 0.5f);
      const float luma_factor = expf(-luma_diff * p.luma_phi);
      const float wl = wgt * luma_factor;
      wgt = (wl + (disoccl_w - wl) * age[s]) * age[s];
      wgt = wgt * (wgt >= 0.0001f ? 1.0f : 0.0f);
#pragma unroll
      for (int i = 0; i < 3; ++i) acc[s][i] = acc[s][i] + wgt * tr[i];
      total[s] = total[s] + wgt;
    }
  }

  const bool is_bg = d_c >= 1.0f;
  float* o = out + (static_cast<size_t>(y) * w + x) * (4 * NT);
#pragma unroll
  for (int s = 0; s < NT; ++s) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      o[4 * s + i] = is_bg ? raw[s][i] : expf(acc[s][i] / total[s]) - 1.0f;
    }
    o[4 * s + 3] = alpha[s];
  }
}

// Texels a tap reaches beyond its pixel along an axis: the offsets'
// largest length there (times the radius; flatness <= 1) in texels,
// rounded as the kernel's floor(centre + offset) rounds, at least 1 (the
// flatness neighbours) and at most kMaxHalo.
int halo(const float* off_x, const float* off_y, float radius, float scale) {
  double reach = 0.0;
  for (int k = 0; k < 8; ++k) {
    reach = fmax(reach, hypot(static_cast<double>(off_x[k]) * scale,
                              static_cast<double>(off_y[k]) * scale));
  }
  reach = fabs(static_cast<double>(radius)) * reach + 0.5;
  if (!(reach < kMaxHalo)) return kMaxHalo;  // NaN and inf too
  return reach < 1.0 ? 1 : static_cast<int>(reach);
}

template <int NT>
int launch(const float* bundle, const float* tile, float* out, int h, int w,
           const PoissonParams& p, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(texel_floats(NT)) * (kBX + 2 * p.hx) *
                      (kBY + 2 * p.hy) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      poisson_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 block(kBX, kBY);
  const dim3 grid((w + kBX - 1) / kBX, (h + kBY - 1) / kBY);
  poisson_kernel<NT><<<grid, block, smem, st>>>(bundle, tile, out, h, w, p);
  return cudaGetLastError();
}

}  // namespace

// ---- host entry points ----
// fparams (host): radius age_e luma_phi depth_phi normal_phi
// roughness_phi specular_phi inv_w inv_h wg hg offx[8] offy[8], of the
// global frame; iparams (host): sy sx then per slot (slot_ch, scalar,
// spec); row0: the global row of the bundle's row 0.
extern "C" int re_poisson(const float* bundle, const float* tile, float* out,
                          int h, int w, int cb, int n_tex, int row0,
                          const float* fparams, const int* iparams,
                          void* stream) {
  if (n_tex < 1 || n_tex > kMaxTex) return cudaErrorInvalidValue;
  PoissonParams p;
  const float* f = fparams;
  p.radius = *f++;
  p.age_e = *f++;
  p.luma_phi = *f++;
  p.depth_phi = *f++;
  p.normal_phi = *f++;
  p.roughness_phi = *f++;
  p.specular_phi = *f++;
  p.inv_w = *f++;
  p.inv_h = *f++;
  p.wg = *f++;
  p.hg = *f++;
  for (int k = 0; k < 8; ++k) p.offx[k] = *f++;
  for (int k = 0; k < 8; ++k) p.offy[k] = *f++;
  p.sy = iparams[0];
  p.sx = iparams[1];
  p.row0 = row0;
  p.hgi = static_cast<int>(p.hg);
  p.cb = cb;
  p.hx = halo(p.offx, p.offy, p.radius, p.wg);
  p.hy = halo(p.offx, p.offy, p.radius, p.hg);
  for (int s = 0; s < kMaxTex; ++s) {
    const bool used = s < n_tex;
    p.slot_ch[s] = used ? iparams[2 + 3 * s] : 0;
    p.scalar[s] = used ? iparams[3 + 3 * s] : 0;
    p.spec[s] = used ? iparams[4 + 3 * s] : 0;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_tex) {
    case 1: return launch<1>(bundle, tile, out, h, w, p, st);
    case 2: return launch<2>(bundle, tile, out, h, w, p, st);
    case 3: return launch<3>(bundle, tile, out, h, w, p, st);
    default: return launch<4>(bundle, tile, out, h, w, p, st);
  }
}
