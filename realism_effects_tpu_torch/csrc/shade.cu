// SSGI's shade pass (ops/ssgi.py _shade_plain, ssgi.frag:241-308) in one
// kernel, one thread a pixel: after the trace, each ray's radiance, the
// environment fallback, the brdf / pdf / MIS weighting and the two packed
// outputs.
//
// Per pixel and ray (the specular, and with mode "ssgi" the diffuse):
// the angles and the Disney diffuse and specular terms with their pdfs
// (core/brdf.py), the environment's colour at a roughness-scaled mip of
// the float16 mip atlas (core/sampling.py sample_mip_atlas), clamped in
// luminance, the reprojected radiance (the sweep's, prewarped and read
// at the hit by the trace; the march's, the velocity nearest the hit and
// last frame's output bilinearly through float16 at hit - velocity),
// desaturated by roughness, faded at the frame's border, the missed-ray
// rule, then brdf / pdf or the MIS weight. Then the -1 mark of pixels
// that took no diffuse sample, the direct light, the world-space length
// of the specular ray and the background's direct light, written as
// g_diffuse = (diffuse GI | -1, roughness) and g_specular = (specular
// GI, ray length), (h, w, 4) each.
//
// The trace mode is a template parameter: the sweep reads its radiance
// and validity from the trace and shares an environment fetch among the
// pixels of each stride x stride quad (_env_fetch_strided: the member
// (frame % s, frame // s % s) of the quad, clamped to the frame's edge,
// fetched with its own ray, roughness and diffuse flag at a rounded lod;
// the luminance clamp is each pixel's own); the march fetches the
// environment trilinearly per pixel. A row block of a larger frame
// (row_offset, frame height) takes its quads from the frame's rows; a
// member past the block's edge is read in the block's halo rows.
//
// The TPU had no kernel for this: the JAX package's shade is XLA
// elementwise code, as the port's plain route is torch elementwise code,
// some 780 whole-frame operations for the sweep's two rays (1150 with
// the march's fetches). The kernel reads the setup's planes, the traces
// and the direct light once and writes the two outputs once (about 200
// bytes a pixel), so it is bound by bytes; the environment atlas and the
// march's fetches come through L1 and L2.
//
// The same operations in the plain route's order (-fmad=false): dot and
// length summed in index order, normalize as a product with the
// reciprocal of the clamped length, the matrix rows as core/math3d.py
// sums them, mix as a + (b - a) * t, a power by 5 as powf and by 2 as a
// product (ATen's pow by a host scalar), the card's atan2f, acosf and
// powf as PyTorch's. A division by a host scalar follows the plain route
// of the tensors' device: PyTorch on CUDA multiplies by the scalar's
// float32 reciprocal, on the CPU it divides (`recip`), so the kernel
// matches the card's plain route on the card and the CPU's in the host
// build of the sources.
#include "common.cuh"

namespace {

constexpr int kBX = 32;  // blocks of 32 x 8 pixels, one a thread
constexpr int kBY = 8;
constexpr int kMaxLevels = 16;  // mip levels of the environment's atlas
constexpr float kEps = 1e-5f;   // ops/ssgi.py EPS, core/brdf.py EPSILON
constexpr float kOneMinusEps = static_cast<float>(1.0 - 1e-5);
constexpr float kPi = 3.14159265358979323846f;

// the host scalars the plain route divides by: pi (the diffuse pdf and
// brdf), 2 pi and pi (the equirect uv), 0.15 (the roughness mip scale),
// 0.15 and (1 - 0.15) - 1 (the border fade's two smoothsteps)
constexpr int kDivPi = 0, kDiv2Pi = 1, kDivRough = 2, kDivBorderLo = 3,
              kDivBorderHi = 4, kNumDiv = 5;

// the planes, in the order of ShadePlanes and of ops/shade_kernel.py's
// PLANES; each is read at pixel (or texel) i at i * its stride
enum Plane {
  kDepth, kRoughness, kMetalness, kDiffuse, kRoughnessSq, kNov, kViewNormal, kN, kV,
  kIsDiffuse, kIsEnv, kEmsPdf, kWorldPos, kRay0, kRay1, kCoords0, kCoords1, kHitPos,
  kMissed0, kMissed1, kRadiance0, kRadiance1, kDirect, kVelocity, kAccumulated, kAtlas,
  kOutDiffuse, kOutSpecular, kNumPlanes
};

struct ShadeParams {
  float cam_world[16];  // the camera's world matrix, row-major
  float view[16];       // the view matrix, row-major
  float cam_pos[3];
  float mip;            // env_blur * the environment's highest mip level
  float box_hi[3], box_lo[3], box_pos[3];  // env_box: 0.5 size + pos, -0.5 size + pos, pos
  float div[kNumDiv], inv_div[kNumDiv];
  int h, w, fh, row_offset;
  int two_rays, missed_rays, has_env, lum_clamp, direct_light, has_box;
  int stride, fy, fx;  // the sweep's shared environment fetch
  int recip;
  int vel_h, vel_w, acc_h, acc_w;  // the march's textures
  int atlas_h, atlas_w, levels;
  int level_off[kMaxLevels], level_h[kMaxLevels], level_w[kMaxLevels];
  int ps[kNumPlanes];  // each plane's stride between pixels, in elements
};

struct ShadePlanes {
  const float* f[kNumPlanes];  // the float32 planes (null where unused)
  const uint8_t* b[kNumPlanes];  // the bool planes
  const __half* atlas;
  float* out[2];  // g_diffuse, g_specular
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }

__device__ __forceinline__ float ld(const ShadeParams& p, const ShadePlanes& q, int k,
                                    long long i) {
  return q.f[k][i * p.ps[k]];
}

__device__ __forceinline__ V3 ld3(const ShadeParams& p, const ShadePlanes& q, int k,
                                  long long i) {
  const float* a = q.f[k] + i * p.ps[k];
  return {a[0], a[1], a[2]};
}

__device__ __forceinline__ bool ldb(const ShadeParams& p, const ShadePlanes& q, int k,
                                    long long i) {
  return q.b[k][i * p.ps[k]] != 0;
}

// x / the host scalar div[k] on the tensors' device (see the top)
__device__ __forceinline__ float sdiv(const ShadeParams& p, float x, int k) {
  return p.recip ? x * p.inv_div[k] : x / p.div[k];
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return re::pmin(re::pmax(x, lo), hi);
}

__device__ __forceinline__ float dot(V3 a, V3 b) {
  float acc = a.x * b.x;
  acc = acc + a.y * b.y;
  return acc + a.z * b.z;
}

__device__ __forceinline__ float length(V3 a) { return sqrtf(dot(a, a)); }

__device__ __forceinline__ V3 normalize(V3 a) {
  return a * (1.0f / re::pmax(length(a), 1e-20f));
}

__device__ __forceinline__ float luminance(V3 c) {
  return (c.x * 0.2125f + c.y * 0.7154f) + c.z * 0.0721f;
}

__device__ __forceinline__ float smoothstep(const ShadeParams& p, float e0, int den, float x) {
  const float t = clampf(sdiv(p, x - e0, den), 0.0f, 1.0f);
  return (t * t) * (3.0f - 2.0f * t);
}

// ---- core/brdf.py ----

__device__ __forceinline__ float d_gtr(float roughness, float noh) {
  const float a2 = roughness * roughness;
  const float t = (noh * noh) * (a2 * a2 - 1.0f) + 1.0f;
  return a2 / (kPi * (t * t));
}

__device__ __forceinline__ float smith_g(float ndotv, float alpha_g) {
  const float a = alpha_g * alpha_g;
  const float b = ndotv * ndotv;
  return (2.0f * ndotv) / (ndotv + sqrtf((a + b) - a * b));
}

__device__ __forceinline__ float f_schlick_one(float f90, float theta) {
  return (f90 - 1.0f) * powf(1.0f - theta, 5.0f) + 1.0f;
}

// ---- the environment: core/envmap.py, core/sampling.py ----

// _atlas_bilinear at the integer level lvl.
__device__ __forceinline__ V3 atlas_bilinear(const ShadeParams& p, const ShadePlanes& q,
                                             float u, float v, float lvl) {
  float off = 0.0f, hl = 1.0f, wl = 1.0f;
  for (int k = 0; k < p.levels; ++k) {
    if (lvl == static_cast<float>(k)) {
      off = static_cast<float>(p.level_off[k]);
      hl = static_cast<float>(p.level_h[k]);
      wl = static_cast<float>(p.level_w[k]);
    }
  }
  const float x = u * wl - 0.5f;
  const float y = v * hl - 0.5f;
  float x0 = floorf(x), y0 = floorf(y);
  const float fx = x0 < 0.0f ? 0.0f : x - x0;
  const float fy = y0 < 0.0f ? 0.0f : y - y0;
  x0 = re::pmin(re::pmax(x0, 0.0f), wl - 1.0f);
  y0 = re::pmin(re::pmax(y0, 0.0f), hl - 1.0f);
  const int iy = re::floor_int(off + y0);
  const int ix = re::floor_int(x0);
  const int ps = p.ps[kAtlas];
  float c[4][3];
  for (int k = 0; k < 4; ++k) {
    const int ty = re::clampi(iy + (k >> 1), 0, p.atlas_h - 1);
    const int tx = re::clampi(ix + (k & 1), 0, p.atlas_w - 1);
    const __half* t = q.atlas + (static_cast<long long>(ty) * p.atlas_w + tx) * ps;
    for (int ch = 0; ch < 3; ++ch) c[k][ch] = __half2float(t[ch]);
  }
  float o[3];
  for (int ch = 0; ch < 3; ++ch) {
    const float top = c[0][ch] + (c[1][ch] - c[0][ch]) * fx;
    const float bot = c[2][ch] + (c[3][ch] - c[2][ch]) * fx;
    o[ch] = top + (bot - top) * fy;
  }
  return {o[0], o[1], o[2]};
}

// sample_equirect_color at the lod, rounded to a level with `quantize`.
__device__ __forceinline__ V3 equirect_color(const ShadeParams& p, const ShadePlanes& q, V3 d,
                                             float lod, bool quantize) {
  const float u = sdiv(p, atan2f(d.z, d.x), kDiv2Pi) + 0.5f;
  const float v = 1.0f - sdiv(p, acosf(clampf(d.y, -1.0f, 1.0f)), kDivPi);
  const float top = static_cast<float>(p.levels - 1);
  lod = clampf(lod, 0.0f, top);
  if (quantize) return atlas_bilinear(p, q, u, v, rintf(lod));
  const float l0 = floorf(lod);
  const float frac = lod - l0;
  const V3 a = atlas_bilinear(p, q, u, v, l0);
  const V3 b = atlas_bilinear(p, q, u, v, re::pmin(l0 + 1.0f, top));
  return a + (b - a) * frac;
}

// The environment's colour for ray l of pixel j before the luminance
// clamp (_get_env_color): the reflected world direction, env_box's
// parallax, the roughness-scaled lod, the fetch.
__device__ __forceinline__ V3 env_fetch(const ShadeParams& p, const ShadePlanes& q,
                                        long long j, V3 l, bool quantize) {
  const float* m = p.view;
  V3 r = normalize({(m[0] * l.x + m[4] * l.y) + m[8] * l.z,
                    (m[1] * l.x + m[5] * l.y) + m[9] * l.z,
                    (m[2] * l.x + m[6] * l.y) + m[10] * l.z});
  if (p.has_box) {  // _parallax_correct
    const V3 wp = ld3(p, q, kWorldPos, j);
    const float rv[3] = {r.x, r.y, r.z}, wv[3] = {wp.x, wp.y, wp.z};
    float corr = 0.0f;
    for (int c = 0; c < 3; ++c) {
      const float safe = fabsf(rv[c]) > 1e-8f ? rv[c] : 1e-8f;
      const float rb = rv[c] > 0.0f ? (p.box_hi[c] - wv[c]) / safe
                                    : (p.box_lo[c] - wv[c]) / safe;
      corr = c == 0 ? rb : re::pmin(corr, rb);
    }
    const V3 pos = {p.box_pos[0], p.box_pos[1], p.box_pos[2]};
    r = normalize((wp + r * corr) - pos);
  }
  const float rough = ld(p, q, kRoughness, j);
  const bool diffuse = ldb(p, q, kIsDiffuse, j);
  const float scale = (!diffuse && rough < 0.15f) ? sdiv(p, rough, kDivRough) : 1.0f;
  return equirect_color(p, q, r, scale * p.mip, quantize);
}

// The luminance clamp of a pixel's environment sample.
__device__ __forceinline__ V3 lum_clamp(const ShadeParams& p, V3 s, bool is_env) {
  if (!p.lum_clamp) return s;
  const float max_lum = is_env ? 100.0f : 25.0f;
  const float lum = luminance(s);
  const float scale = lum > max_lum ? max_lum / re::pmax(lum, kEps) : 1.0f;
  return s * scale;
}

// The member of pixel (y, x)'s stride x stride quad whose fetch the quad
// shares (_env_fetch_strided), as a pixel index of the block.
__device__ __forceinline__ long long quad_member(const ShadeParams& p, int y, int x) {
  const int s = p.stride;
  const int g0 = max(p.row_offset, 0);
  const int g1 = min(p.row_offset + p.h, p.fh) - 1;
  const int gy = re::clampi(y + p.row_offset, g0, g1);
  const int my = re::clampi(min((gy / s) * s + p.fy, p.fh - 1) - p.row_offset, 0, p.h - 1);
  const int mx = min((x / s) * s + p.fx, p.w - 1);
  return static_cast<long long>(my) * p.w + mx;
}

// The shared radiance of one ray: gi (before the weighting), brdf * cos
// and pdf (do_sample).
struct Sample {
  V3 gi;
  float brdf, pdf;
};

template <bool kSweep>
__device__ __forceinline__ Sample do_sample(const ShadeParams& p, const ShadePlanes& q, int y,
                                            int x, long long i, int ray, bool mask, bool is_env,
                                            float sat_desat) {
  const V3 l = ld3(p, q, kRay0 + ray, i);
  const V3 v = ld3(p, q, kV, i);
  const V3 n = ld3(p, q, kN, i);
  const V3 vn = ld3(p, q, kViewNormal, i);
  const float nov = ld(p, q, kNov, i);
  const float rsq = ld(p, q, kRoughnessSq, i);
  const float metal = ld(p, q, kMetalness, i);
  // calculate_angles
  const V3 h = normalize(v + l);
  const float nol = clampf(dot(n, l), kEps, kOneMinusEps);
  const float noh = clampf(dot(n, h), kEps, kOneMinusEps);
  const float loh = clampf(dot(l, h), kEps, kOneMinusEps);
  const float cos_theta = re::pmax(dot(vn, l), 0.0f);
  Sample s;
  if (mask) {
    // eval_disney_diffuse, the cosine pdf
    const float fd90 = 0.5f + (2.0f * rsq) * (loh * loh);
    const float a = f_schlick_one(fd90, nol);
    const float b = f_schlick_one(fd90, nov);
    s.brdf = sdiv(p, a * b, kDivPi) * (1.0f - metal);
    s.pdf = sdiv(p, nol, kDivPi);
  } else {
    // eval_disney_specular, ggx_vndf_pdf
    const float d = d_gtr(rsq, noh);
    float rr = 0.5f + rsq * 0.5f;
    rr = rr * rr;
    const float a2 = rr * rr;
    const float g = smith_g(nov, a2) * smith_g(nol, a2);
    s.brdf = (d * g) / ((4.0f * nol) * nov);
    s.pdf = (d * smith_g(nov, rsq * rsq)) / re::pmax(4.0f * nov, 1e-5f);
  }
  s.pdf = re::pmax(s.pdf, kEps);
  s.brdf = s.brdf * cos_theta;

  V3 env = {0.0f, 0.0f, 0.0f};
  if (p.has_env) {
    if (kSweep && p.stride > 1) {
      const long long j = quad_member(p, y, x);
      env = env_fetch(p, q, j, ld3(p, q, kRay0 + ray, j), true);
    } else {
      env = env_fetch(p, q, i, l, kSweep);
    }
    env = lum_clamp(p, env, is_env);
  }

  const float* coords = q.f[kCoords0 + ray] + i * p.ps[kCoords0 + ray];
  const float cu = coords[0], cv = coords[1];
  V3 g;
  bool in_bounds;
  if (kSweep) {
    // the prewarped radiance (+ validity) read at the hit texel
    const float* r = q.f[kRadiance0 + ray] + i * p.ps[kRadiance0 + ray];
    g = {r[0], r[1], r[2]};
    in_bounds = r[3] > 0.5f;
  } else {
    // the velocity (nearest) at the hit, then last frame's output there
    // through float16, bilinear (sample_bilinear)
    const int vx = re::clampi(re::floor_int(cu * static_cast<float>(p.vel_w)), 0, p.vel_w - 1);
    const int vy = re::clampi(re::floor_int(cv * static_cast<float>(p.vel_h)), 0, p.vel_h - 1);
    const float* vel =
        q.f[kVelocity] + (static_cast<long long>(vy) * p.vel_w + vx) * p.ps[kVelocity];
    const float ru = cu - vel[0];
    const float rv = cv - vel[1];
    in_bounds = ru >= 0.0f && ru <= 1.0f && rv >= 0.0f && rv <= 1.0f;
    const float fxx = ru * static_cast<float>(p.acc_w) - 0.5f;
    const float fyy = rv * static_cast<float>(p.acc_h) - 0.5f;
    const float x0 = floorf(fxx), y0 = floorf(fyy);
    const float fx = x0 < 0.0f ? 0.0f : fxx - x0;
    const float fy = y0 < 0.0f ? 0.0f : fyy - y0;
    const int ix = re::floor_int(x0), iy = re::floor_int(y0);
    float c[4][3];
    for (int k = 0; k < 4; ++k) {
      const int ty = re::clampi(iy + (k >> 1), 0, p.acc_h - 1);
      const int tx = re::clampi(ix + (k & 1), 0, p.acc_w - 1);
      const float* t = q.f[kAccumulated] +
                       (static_cast<long long>(ty) * p.acc_w + tx) * p.ps[kAccumulated];
      for (int ch = 0; ch < 3; ++ch) c[k][ch] = __half2float(__float2half_rn(t[ch]));
    }
    float o[3];
    for (int ch = 0; ch < 3; ++ch) {
      const float top = c[0][ch] + (c[1][ch] - c[0][ch]) * fx;
      const float bot = c[2][ch] + (c[3][ch] - c[2][ch]) * fx;
      o[ch] = top + (bot - top) * fy;
    }
    g = {o[0], o[1], o[2]};
  }
  // desaturate by roughness: mix(g, luminance(g), sat_desat)
  const float lum = luminance(g);
  g = {g.x + (lum - g.x) * sat_desat, g.y + (lum - g.y) * sat_desat,
       g.z + (lum - g.z) * sat_desat};
  float bf = smoothstep(p, 0.0f, kDivBorderLo, cu) * smoothstep(p, 1.0f, kDivBorderHi, cu);
  bf = bf * smoothstep(p, 0.0f, kDivBorderLo, cv);
  bf = bf * smoothstep(p, 1.0f, kDivBorderHi, cv);
  bf = sqrtf(re::pmax(bf, 0.0f));
  V3 radiance = env + (g - env) * bf;
  if (!in_bounds) radiance = env;
  const bool missed = ldb(p, q, kMissed0 + ray, i);
  if (p.missed_rays) {
    // the brighter of env and ssgi on missed lanes
    s.gi = (missed && luminance(env) > luminance(radiance)) ? env : radiance;
  } else {
    s.gi = missed ? env : radiance;
  }
  return s;
}

// brdf / pdf / MIS weighting (finalize)
__device__ __forceinline__ V3 finalize(const Sample& s, float ems_pdf, bool is_env) {
  const V3 gi = s.gi * s.brdf;
  const float aa = ems_pdf * ems_pdf;
  const float mis = aa / (aa + s.pdf * s.pdf);
  const float weight = is_env ? mis : 1.0f / s.pdf;
  return gi * (weight / ems_pdf);
}

__device__ __forceinline__ void store4(float* out, long long i, V3 c, float a) {
  re::F4 o;
  o.v[0] = c.x;
  o.v[1] = c.y;
  o.v[2] = c.z;
  o.v[3] = a;
  if ((reinterpret_cast<uintptr_t>(out) & 15u) == 0) {
    reinterpret_cast<re::F4*>(out)[i] = o;
    return;
  }
  for (int c = 0; c < 4; ++c) out[4 * i + c] = o.v[c];
}

template <bool kSweep>
__global__ void __launch_bounds__(kBX * kBY) shade_kernel(const ShadeParams p,
                                                          const ShadePlanes q) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= p.w || y >= p.h) return;
  const long long i = static_cast<long long>(y) * p.w + x;
  const float rough = ld(p, q, kRoughness, i);
  const V3 dl = ld3(p, q, kDirect, i);
  if (ld(p, q, kDepth, i) >= 1.0f) {  // the background shows the direct light
    store4(q.out[0], i, dl, 0.0f);
    store4(q.out[1], i, dl, 0.0f);
    return;
  }
  const bool ids = ldb(p, q, kIsDiffuse, i);
  const bool ies = ldb(p, q, kIsEnv, i);
  const float ems_pdf = ld(p, q, kEmsPdf, i);
  // _saturation of the albedo, desaturation weight
  const V3 c = ld3(p, q, kDiffuse, i);
  const float mx = re::pmax(re::pmax(c.x, c.y), c.z);
  const float mn = re::pmin(re::pmin(c.x, c.y), c.z);
  const float sat = mx == mn ? 0.0f : (mx - mn) / re::pmax(mx, kEps);
  const float sat_desat = ((1.0f - rough) * sat) * 0.4f;

  // the specular ray takes the pixel's isDiffuseSample flag too
  const Sample spec = do_sample<kSweep>(p, q, y, x, i, 0, ids, ies, sat_desat);
  V3 specular = finalize(spec, ems_pdf, ies);
  V3 diffuse = {-1.0f, -1.0f, -1.0f};
  if (p.two_rays) {
    const Sample diff = do_sample<kSweep>(p, q, y, x, i, 1, ids, ies, sat_desat);
    if (ids) diffuse = finalize(diff, ems_pdf, ies);
  }
  if (p.direct_light) {
    specular = specular + dl;
    if (p.two_rays && ids) diffuse = diffuse + dl;
  }
  // world-space ray length for hit-point reprojection
  const V3 hp = ld3(p, q, kHitPos, i);
  float ray_length = 0.0f;
  if (!(hp.x > 1.0e8f)) {
    const float* m = p.cam_world;
    float rw[4];
    for (int r = 0; r < 4; ++r) {
      rw[r] = ((m[4 * r] * hp.x + m[4 * r + 1] * hp.y) + m[4 * r + 2] * hp.z) + m[4 * r + 3];
    }
    const V3 to_hit = {rw[0] / rw[3] - p.cam_pos[0], rw[1] / rw[3] - p.cam_pos[1],
                       rw[2] / rw[3] - p.cam_pos[2]};
    ray_length = length(to_hit);
  }
  store4(q.out[0], i, diffuse, rough);
  store4(q.out[1], i, specular, ray_length);
}

// The launch parameters from the host arrays (see re_shade).
void unpack(const int* ip, const float* fp, ShadeParams& p) {
  int k = 0;
  for (int j = 0; j < 16; ++j) p.cam_world[j] = fp[k++];
  for (int j = 0; j < 16; ++j) p.view[j] = fp[k++];
  for (int j = 0; j < 3; ++j) p.cam_pos[j] = fp[k++];
  p.mip = fp[k++];
  for (int j = 0; j < 3; ++j) p.box_hi[j] = fp[k++];
  for (int j = 0; j < 3; ++j) p.box_lo[j] = fp[k++];
  for (int j = 0; j < 3; ++j) p.box_pos[j] = fp[k++];
  for (int j = 0; j < kNumDiv; ++j) p.div[j] = fp[k++];
  for (int j = 0; j < kNumDiv; ++j) p.inv_div[j] = fp[k++];
  int* ints[] = {&p.h, &p.w, &p.fh, &p.row_offset, &p.two_rays, &p.missed_rays, &p.has_env,
                 &p.lum_clamp, &p.direct_light, &p.has_box, &p.stride, &p.fy, &p.fx,
                 &p.recip, &p.vel_h, &p.vel_w, &p.acc_h, &p.acc_w, &p.atlas_h, &p.atlas_w,
                 &p.levels};
  k = 0;
  for (int* v : ints) *v = ip[k++];
  for (int j = 0; j < kMaxLevels; ++j) {
    p.level_off[j] = ip[k++];
    p.level_h[j] = ip[k++];
    p.level_w[j] = ip[k++];
  }
  for (int j = 0; j < kNumPlanes; ++j) p.ps[j] = ip[k++];
}

}  // namespace

// ---- host entry point ----
// sweep: 1 the sweep's trace, 0 the march's. ptrs (host): the device
// pointers of the planes in the order of enum Plane (null where unused;
// the atlas float16, the two outputs last). iparams (host): h, w, frame
// height, row offset, two rays, missed rays, environment, luminance
// clamp, direct light, env box, the fetch stride and its member row and
// column, recip, the velocity's and the accumulated output's h and w,
// the atlas's h, w and levels, each of kMaxLevels levels' row offset, h
// and w, each plane's pixel stride. fparams (host): the camera's world
// and the view matrices (16 floats each, row-major), the camera
// position, the mip, env_box's high and low corners and position, the
// divisors and their reciprocals.
extern "C" int re_shade(int sweep, const void* const* ptrs, const int* iparams,
                        const float* fparams, void* stream) {
  ShadeParams p;
  unpack(iparams, fparams, p);
  if (p.h < 0 || p.w < 0 || p.fh < 1 || p.levels < 0 || p.levels > kMaxLevels ||
      (p.has_env && p.levels < 1) || (sweep && p.stride > 1 && (p.fy < 0 || p.fx < 0))) {
    return cudaErrorInvalidValue;
  }
  if (p.h == 0 || p.w == 0) return cudaSuccess;
  ShadePlanes q;
  for (int k = 0; k < kNumPlanes; ++k) {
    q.f[k] = static_cast<const float*>(ptrs[k]);
    q.b[k] = static_cast<const uint8_t*>(ptrs[k]);
  }
  q.atlas = static_cast<const __half*>(ptrs[kAtlas]);
  q.out[0] = static_cast<float*>(const_cast<void*>(ptrs[kOutDiffuse]));
  q.out[1] = static_cast<float*>(const_cast<void*>(ptrs[kOutSpecular]));
  const dim3 block(kBX, kBY);
  const dim3 grid((p.w + kBX - 1) / kBX, (p.h + kBY - 1) / kBY);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sweep) {
    shade_kernel<true><<<grid, block, 0, st>>>(p, q);
  } else {
    shade_kernel<false><<<grid, block, 0, st>>>(p, q);
  }
  return cudaGetLastError();
}
