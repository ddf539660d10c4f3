// Temporal reprojection's per-pixel work (ops/temporal_reproject.py):
// everything but its fetches, in two kernels a reprojection.
//
// reproject_prepare_kernel, one thread a pixel: the pixel's uv (uv_grid
// at its global row), with `dilation` the 3x3 closest-depth dilation
// (edges replicated, strict <, the first of a tie wins, the plain
// route's visiting order), the world position, the move factor, the
// diffuse uv (uv - velocity) and, where a slot reprojects specular, the
// curvature (fwidth's forward differences, zero at the frame's last row
// and column) and the hit point's uv and validity. It writes what the
// existing fetches read: the last frame's packed normal and depth (the
// nearest probes' texture), the int32 targets of the nearest probes at
// the diffuse and the hit uv, the int32 targets and float fractions of
// each slot's 5-tap Catmull-Rom history fetch, and each slot's history
// rounded through float16 (the rgba16f history target).
//
// reproject_blend_kernel, one thread a pixel and every slot: the
// disocclusion confidence of each probe (_validate_reprojected_uv), the
// Catmull-Rom normalisation, the neighbourhood clamp seeded with the
// pixel's input, the `sampled` selects, the confidence-weighted
// accumulation and the effective-sample-count alpha, written as the
// slot's RGBA output. The geometry (uv, dilation, world position, move
// factor, hit point) is recomputed from the velocity buffer rather than
// stored by the prepare kernel and read back.
//
// Between the two, ops/temporal_reproject.py launches the fetches the
// plain route launches: window_warp's nearest mode a probe, its catrom5
// mode a slot, neighborhood_minmax at radius 2 a slot and at radius 1
// for a specular slot.
//
// The TPU had no kernel for this: the JAX package's reprojection is
// XLA elementwise code around the warp and minmax kernels, as the
// port's plain route is torch elementwise code, some 250 whole-frame
// operations a slot. Each kernel reads and writes each of its planes
// once (172 and 226 bytes a pixel for SSGI's two slots, 112 and 121 for
// TRAA's one), so both are bound by bytes; the 16-byte planes move as
// 16-byte loads and stores where they are 16-byte aligned. Neighbours'
// normals and depths (curvature, dilation) come through L1 and L2.
//
// The same operations in the plain route's order (-fmad=false): the
// matrix rows summed as core/math3d.py's _apply_rows sums them, rdiv as
// one division, mix as a + (b - a) * t, length and dot summed in index
// order, logf and expf for the log transform, and a power by a host
// scalar as ATen takes it (pow_aten). A division by a host scalar
// follows the plain route of the tensors' device: PyTorch on CUDA
// multiplies by the scalar's float32 reciprocal, on the CPU it divides
// (`recip`), so the kernels match the card's plain route on the card and
// the CPU's in the host build of the sources.
#include "common.cuh"

namespace {

constexpr int kMaxSlots = 2;  // SSGI's two; TRAA and SSR take one
constexpr int kBX = 32;  // blocks of 32 x 8 pixels, one a thread
constexpr int kBY = 8;

// reproject.frag:107-109, temporal_reproject.frag:68
constexpr int kWorldDistance = 0, kPlaneDistance = 1, kNormalDistance = 2,
              kRoughnessMaximum = 3;

struct ReprojectParams {
  // 4x4 row-major matrices: the camera's world and inverse projection,
  // the previous camera's world, inverse projection, view, projection
  float cam_world[16], cam_proj_inv[16], prev_world[16], prev_proj_inv[16],
      prev_view[16], prev_proj[16];
  float cam_pos[3];
  float z0, z1, z2;  // depth law: perspective nf, f - n, f; else n - f, n
  float max_value, clamp_intensity, confidence_power;
  float inv_w, inv_fh;                   // 1 / w, 1 / frame height
  float div[4], inv_div[4];              // 10, 20, 1, 0.1 and reciprocals
  int h, w, fh, row_offset, n_slots, spec_mask, gate, log_transform,
      dilation, perspective, recip, pow_law, ray_stride, rough_stride;
};

// Device planes (row-major, the block's h x w pixels).
struct ReprojectPlanes {
  const float* vel;          // (h, w, 2)
  const float* normal;       // (h, w, 3)
  const float* depth;        // (h, w)
  const float* last_normal;  // (h, w, 3)
  const float* last_depth;   // (h, w)
  const float* ray;          // the ray length, at i * ray_stride; or null
  const float* rough;        // roughness, at i * rough_stride; or null
  const float* history[kMaxSlots];  // (h, w, 4) each
  const float* input[kMaxSlots];    // (h, w, 4) each
  const float* probe_nd[2];         // the nearest probes' (h, w, 4)
  const uint8_t* probe_ok[2];       // and in-window flags (h, w)
  const float* fetched[kMaxSlots];  // the catrom5 fetches (h, w, 4)
  const float* box_min2[kMaxSlots];  // radius-2 minmax (h, w, 4)
  const float* box_max2[kMaxSlots];
  const float* box_min1[kMaxSlots];  // radius-1, specular slots
  const float* box_max1[kMaxSlots];
  float* nd;                 // out: (h, w, 4) last normal, last depth
  int* targets;              // out: (2 probes + 2 slots, h, w) int32
  float* fracs;              // out: (2 slots, h, w)
  float* history16[kMaxSlots];  // out: (h, w, 4) each
  float* out[kMaxSlots];        // out: (h, w, 4) each
};

__device__ __forceinline__ re::F4 ld4(const float* p, long long i) {
  if ((reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
    return reinterpret_cast<const re::F4*>(p)[i];
  }
  re::F4 r;
  for (int c = 0; c < 4; ++c) r.v[c] = p[4 * i + c];
  return r;
}

__device__ __forceinline__ void st4(float* p, long long i, const re::F4& v) {
  if ((reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
    reinterpret_cast<re::F4*>(p)[i] = v;
    return;
  }
  for (int c = 0; c < 4; ++c) p[4 * i + c] = v.v[c];
}

// x / the host scalar div[k] on the tensors' device (see the top)
__device__ __forceinline__ float sdiv(const ReprojectParams& p, float x, int k) {
  return p.recip ? x * p.inv_div[k] : x / p.div[k];
}

// x ** e for a host scalar e as ATen's pow takes it (law from the
// wrapper): 0 powf, 1 x * x, 2 x * x * x, 3 sqrtf, 4 one, 5 x
__device__ __forceinline__ float pow_aten(const ReprojectParams& p, float x) {
  switch (p.pow_law) {
    case 1: return x * x;
    case 2: return x * x * x;
    case 3: return sqrtf(x);
    case 4: return 1.0f;
    case 5: return x;
    default: return powf(x, p.confidence_power);
  }
}

__device__ __forceinline__ float transform(const ReprojectParams& p, float c) {
  return p.log_transform ? logf(c + 1.0f) : c;
}

__device__ __forceinline__ float undo_transform(const ReprojectParams& p, float c) {
  return p.log_transform ? expf(c) - 1.0f : c;
}

// Row r of m applied to (x, y, z, 1), as _apply_rows sums it.
__device__ __forceinline__ float row(const float* m, int r, float x, float y, float z) {
  return ((m[4 * r] * x + m[4 * r + 1] * y) + m[4 * r + 2] * z) + m[4 * r + 3];
}

// transform_point: the rows, then the w-divide.
__device__ __forceinline__ void transform_point(const float* m, float& x, float& y,
                                                float& z) {
  const float rx = row(m, 0, x, y, z), ry = row(m, 1, x, y, z),
              rz = row(m, 2, x, y, z), rw = row(m, 3, x, y, z);
  x = rx / rw;
  y = ry / rw;
  z = rz / rw;
}

// screen_to_world(uv, depth, world, proj_inv)
__device__ __forceinline__ void screen_to_world(const float* world, const float* proj_inv,
                                                float u, float v, float d, float w3[3]) {
  float x = (u - 0.5f) * 2.0f, y = (v - 0.5f) * 2.0f, z = (d - 0.5f) * 2.0f;
  transform_point(proj_inv, x, y, z);
  transform_point(world, x, y, z);
  w3[0] = x;
  w3[1] = y;
  w3[2] = z;
}

// The velocity, normal and depth of pixel (y, x), closest-depth dilated
// with `dilation` (_dilate_closest).
__device__ __forceinline__ void center(const ReprojectParams& p, const ReprojectPlanes& q,
                                       int y, int x, float vel[2], float n[3], float& d) {
  long long best = static_cast<long long>(y) * p.w + x;
  d = q.depth[best];
  if (p.dilation) {
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const long long j = static_cast<long long>(re::clampi(y + dy, 0, p.h - 1)) * p.w +
                            re::clampi(x + dx, 0, p.w - 1);
        const float dj = q.depth[j];
        if (dj < d) {
          d = dj;
          best = j;
        }
      }
    }
  }
  vel[0] = q.vel[2 * best];
  vel[1] = q.vel[2 * best + 1];
  n[0] = q.normal[3 * best];
  n[1] = q.normal[3 * best + 1];
  n[2] = q.normal[3 * best + 2];
}

// A pixel's geometry, the same in both kernels.
struct Geometry {
  float n[3], depth, world[3], move_factor;
  float du, dv;        // diffuse uv
  float hu, hv;        // hit uv (where a slot reprojects specular)
  bool hit_valid;
};

__device__ __forceinline__ Geometry geometry(const ReprojectParams& p,
                                             const ReprojectPlanes& q, int y, int x) {
  Geometry g;
  // uv_grid: (x + 0.5) / w and (global row + 0.5) / frame height
  const float ux = static_cast<float>(x) + 0.5f;
  const float vy = static_cast<float>(y + p.row_offset) + 0.5f;
  const float u = p.recip ? ux * p.inv_w : ux / static_cast<float>(p.w);
  const float v = p.recip ? vy * p.inv_fh : vy / static_cast<float>(p.fh);
  float vel[2];
  center(p, q, y, x, vel, g.n, g.depth);
  screen_to_world(p.cam_world, p.cam_proj_inv, u, v, g.depth, g.world);
  g.move_factor = re::pmin((vel[0] * vel[0] + vel[1] * vel[1]) * 10000.0f, 1.0f);
  g.du = u - vel[0];
  g.dv = v - vel[1];
  g.hu = g.du;
  g.hv = g.dv;
  g.hit_valid = false;
  if (p.spec_mask == 0) return g;
  // curvature: length(fwidth(normal)), forward differences
  float fw[3];
  float nr[3] = {0.0f, 0.0f, 0.0f}, nu[3] = {0.0f, 0.0f, 0.0f}, tv[2], td;
  const bool has_right = x < p.w - 1;
  const bool has_up = y < p.h - 1 && y < p.fh - 1 - p.row_offset;
  if (has_right) center(p, q, y, x + 1, tv, nr, td);
  if (has_up) center(p, q, y + 1, x, tv, nu, td);
  for (int c = 0; c < 3; ++c) {
    const float ddx = has_right ? nr[c] - g.n[c] : 0.0f;
    const float ddy = has_up ? nu[c] - g.n[c] : 0.0f;
    fw[c] = fabsf(ddx) + fabsf(ddy);
  }
  const float curvature = sqrtf((fw[0] * fw[0] + fw[1] * fw[1]) + fw[2] * fw[2]);
  // _reproject_hit_point (reproject.frag:169-193)
  const long long i = static_cast<long long>(y) * p.w + x;
  const float ray_length = q.ray != nullptr ? q.ray[i * p.ray_stride] : 0.0f;
  g.hit_valid = curvature <= 0.05f && ray_length >= 0.01f;
  float r[3];
  for (int c = 0; c < 3; ++c) r[c] = g.world[c] - p.cam_pos[c];
  const float len = sqrtf((r[0] * r[0] + r[1] * r[1]) + r[2] * r[2]);
  const float inv = 1.0f / re::pmax(len, 1e-20f);
  float hx = p.cam_pos[0] + (r[0] * inv) * ray_length;
  float hy = p.cam_pos[1] + (r[1] * inv) * ray_length;
  float hz = p.cam_pos[2] + (r[2] * inv) * ray_length;
  transform_point(p.prev_view, hx, hy, hz);
  const float cx = row(p.prev_proj, 0, hx, hy, hz), cy = row(p.prev_proj, 1, hx, hy, hz),
              cw = row(p.prev_proj, 3, hx, hy, hz);
  const float sw = fabsf(cw) > 1e-8f ? cw : 1e-8f;
  g.hu = (cx / sw) * 0.5f + 0.5f;
  g.hv = (cy / sw) * 0.5f + 0.5f;
  return g;
}

__device__ __forceinline__ bool is_spec(const ReprojectParams& p, int s) {
  return (p.spec_mask >> s) & 1;
}

// The uv slot s fetches its history at: the specular uv (the hit uv
// where valid) or the diffuse uv.
__device__ __forceinline__ void slot_uv(const ReprojectParams& p, const Geometry& g, int s,
                                        float& u, float& v) {
  const bool hit = is_spec(p, s) && g.hit_valid;
  u = hit ? g.hu : g.du;
  v = hit ? g.hv : g.dv;
}

// catmull_rom5_window's split of uv: the texel below-left and the
// fractions.
__device__ __forceinline__ void split(const ReprojectParams& p, float u, float v, float& x0,
                                      float& y0, float& fx, float& fy) {
  const float x = u * static_cast<float>(p.w) - 0.5f;
  const float y = v * static_cast<float>(p.fh) - 0.5f;
  x0 = floorf(x);
  y0 = floorf(y);
  fx = x - x0;
  fy = y - y0;
}

__global__ void __launch_bounds__(kBX * kBY)
reproject_prepare_kernel(const ReprojectParams p, const ReprojectPlanes q) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= p.w || y >= p.h) return;
  const long long i = static_cast<long long>(y) * p.w + x;
  const long long plane = static_cast<long long>(p.h) * p.w;
  const Geometry g = geometry(p, q, y, x);

  re::F4 nd;
  nd.v[0] = q.last_normal[3 * i];
  nd.v[1] = q.last_normal[3 * i + 1];
  nd.v[2] = q.last_normal[3 * i + 2];
  nd.v[3] = q.last_depth[i];
  st4(q.nd, i, nd);

  // nearest_window's targets: the diffuse uv's, then the hit uv's
  const int n_probes = p.spec_mask != 0 ? 2 : 1;
  for (int k = 0; k < n_probes; ++k) {
    const float u = k == 0 ? g.du : g.hu;
    const float v = k == 0 ? g.dv : g.hv;
    q.targets[(2 * k) * plane + i] =
        re::floor_int(v * static_cast<float>(p.fh)) - p.row_offset;
    q.targets[(2 * k + 1) * plane + i] = re::floor_int(u * static_cast<float>(p.w));
  }
  for (int s = 0; s < p.n_slots; ++s) {
    float u, v, x0, y0, fx, fy;
    slot_uv(p, g, s, u, v);
    split(p, u, v, x0, y0, fx, fy);
    q.targets[(2 * n_probes + 2 * s) * plane + i] = re::floor_int(y0) - p.row_offset;
    q.targets[(2 * n_probes + 2 * s + 1) * plane + i] = re::floor_int(x0);
    q.fracs[(2 * s) * plane + i] = fy;
    q.fracs[(2 * s + 1) * plane + i] = fx;
    re::F4 hist = ld4(q.history[s], i);
    for (int c = 0; c < 4; ++c) hist.v[c] = __half2float(__float2half_rn(hist.v[c]));
    st4(q.history16[s], i, hist);
  }
}

// _validate_reprojected_uv at (u, v) with the probe's packed normal and
// depth `nd` and in-window flag `ok`; `dist_factor` is the pixel's.
__device__ __forceinline__ float confidence(const ReprojectParams& p, const Geometry& g,
                                            float dist_factor, float u, float v,
                                            const re::F4& nd, bool ok) {
  const bool in_bounds = u >= 0.0f && u <= 1.0f && v >= 0.0f && v <= 1.0f && ok;
  float last[3];
  screen_to_world(p.prev_world, p.prev_proj_inv, u, v, nd.v[3], last);
  float tc[3];
  for (int c = 0; c < 3; ++c) tc[c] = g.world[c] - last[c];
  const float world_dist = sqrtf((tc[0] * tc[0] + tc[1] * tc[1]) + tc[2] * tc[2]);
  const float plane_dist =
      fabsf((tc[0] * g.n[0] + tc[1] * g.n[1]) + tc[2] * g.n[2]);
  const float normal_dist = re::pmin(
      1.0f - ((g.n[0] * nd.v[0] + g.n[1] * nd.v[1]) + g.n[2] * nd.v[2]), 1.0f);
  const float disoccl = (sdiv(p, world_dist, kWorldDistance) * dist_factor +
                         sdiv(p, plane_dist, kPlaneDistance) * dist_factor) +
                        sdiv(p, normal_dist, kNormalDistance) * dist_factor;
  float conf = re::pmax(1.0f - re::pmin(disoccl, 1.0f), 0.0f);
  conf = pow_aten(p, conf);
  return in_bounds ? conf : 0.0f;
}

// Catmull-Rom weights w0 and w3 of fraction f (ops/warp.py _crw).
__device__ __forceinline__ void crw_outer(float f, float& w0, float& w3) {
  const float f2 = f * f;
  const float f3 = f2 * f;
  w0 = f2 - 0.5f * (f3 + f);
  w3 = 0.5f * (f3 - f2);
}

__global__ void __launch_bounds__(kBX * kBY)
reproject_blend_kernel(const ReprojectParams p, const ReprojectPlanes q) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= p.w || y >= p.h) return;
  const long long i = static_cast<long long>(y) * p.w + x;
  const Geometry g = geometry(p, q, y, x);

  // view z and the distance factor (depth_to_view_z)
  const float view_z =
      fabsf(p.perspective ? p.z0 / (p.z1 * g.depth - p.z2) : g.depth * p.z0 - p.z1);
  const float dist_factor = 1.0f + 1.0f / (view_z + 1.0f);
  const float diffuse_conf = confidence(p, g, dist_factor, g.du, g.dv, ld4(q.probe_nd[0], i),
                                        q.probe_ok[0][i] != 0);
  float specular_conf = diffuse_conf;
  if (p.spec_mask != 0) {
    const float hit_conf = confidence(p, g, dist_factor, g.hu, g.hv, ld4(q.probe_nd[1], i),
                                      q.probe_ok[1][i] != 0);
    specular_conf = g.hit_valid ? hit_conf : diffuse_conf;
  }
  const float rough =
      q.rough != nullptr
          ? re::pmin(re::pmax(q.rough[i * p.rough_stride], 0.0f), 1.0f)
          : 1.0f;

  for (int s = 0; s < p.n_slots; ++s) {
    const bool spec = is_spec(p, s);
    const float conf = spec ? specular_conf : diffuse_conf;
    const re::F4 inp = ld4(q.input[s], i);
    const bool sampled = inp.v[0] >= 0.0f;
    float in_rgb[3], center_rgb[3];
    for (int c = 0; c < 3; ++c) {
      in_rgb[c] = transform(p, re::pmax(inp.v[c], 0.0f));
      center_rgb[c] = undo_transform(p, in_rgb[c]);
    }
    // the history fetch, normalised by the 5 taps' weight total
    float u, v, x0, y0, fx, fy, w0x, w3x, w0y, w3y;
    slot_uv(p, g, s, u, v);
    split(p, u, v, x0, y0, fx, fy);
    crw_outer(fx, w0x, w3x);
    crw_outer(fy, w0y, w3y);
    const float total = 1.0f - (w0x + w3x) * (w0y + w3y);
    const re::F4 fetched = ld4(q.fetched[s], i);
    float acc[4];
    for (int c = 0; c < 4; ++c) acc[c] = re::pmax(fetched.v[c] / total, 0.0f);
    float acc_rgb[3], raw[3];
    for (int c = 0; c < 3; ++c) raw[c] = acc_rgb[c] = transform(p, acc[c]);
    float acc_a = acc[3] + 1.0f;

    // the neighbourhood clamp (reproject.frag:53-81)
    const bool use1 = spec && rough < 0.25f;
    const re::F4 mn4 = ld4(use1 ? q.box_min1[s] : q.box_min2[s], i);
    const re::F4 mx4 = ld4(use1 ? q.box_max1[s] : q.box_max2[s], i);
    const float r = spec ? rough : 1.0f;
    const float clamp_aggr = re::pmin(conf * r, 1.0f);
    const float clamp_intensity =
        re::pmin(g.move_factor * 50.0f + p.clamp_intensity, 1.0f) * clamp_aggr;
    float d[3];
    for (int c = 0; c < 3; ++c) {
      const float mn = transform(p, re::pmin(mn4.v[c], center_rgb[c]));
      const float mx = transform(p, re::pmax(mx4.v[c], center_rgb[c]));
      const float clamped = re::pmin(re::pmax(acc_rgb[c], mn), mx);
      const float next = acc_rgb[c] + (clamped - acc_rgb[c]) * clamp_intensity;
      d[c] = next - acc_rgb[c];
      acc_rgb[c] = next;
    }
    const float color_diff = re::pmin(sqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]), 1.0f);
    acc_a = acc_a * (1.0f - color_diff);
    // nothing sampled this frame: the input is the unclamped history
    if (!sampled) {
      for (int c = 0; c < 3; ++c) in_rgb[c] = acc_rgb[c] = raw[c];
      acc_a = acc[3];
    }

    // accumulate (temporal_reproject.frag:42-79)
    const float conf2 = pow_aten(p, conf);
    const float accum_blend = (1.0f - 1.0f / (acc_a + 1.0f)) * conf2;
    float mv = p.max_value;
    if (p.gate && spec) {
      const bool low_rough = rough >= 0.0f && rough < 0.1f;
      const float max_rough = mv * sdiv(p, rough, kRoughnessMaximum);
      const float gated = mv + (max_rough - mv) * re::pmin(g.move_factor * 100.0f, 1.0f);
      mv = low_rough ? gated : mv;
    }
    const float t = re::pmin(accum_blend, mv);
    re::F4 out;
    for (int c = 0; c < 3; ++c) {
      out.v[c] = undo_transform(p, in_rgb[c] + (acc_rgb[c] - in_rgb[c]) * t);
    }
    out.v[3] = re::pmin(1.0f / (1.0f - t) - 1.0f, 65536.0f);
    st4(q.out[s], i, out);
  }
}

// The launch parameters from the host arrays (see re_reproject).
void unpack(const int* ip, const float* fp, ReprojectParams& p) {
  float* mats[6] = {p.cam_world, p.cam_proj_inv, p.prev_world, p.prev_proj_inv,
                    p.prev_view, p.prev_proj};
  for (int m = 0; m < 6; ++m) {
    for (int k = 0; k < 16; ++k) mats[m][k] = fp[16 * m + k];
  }
  for (int c = 0; c < 3; ++c) p.cam_pos[c] = fp[96 + c];
  p.z0 = fp[99];
  p.z1 = fp[100];
  p.z2 = fp[101];
  p.max_value = fp[102];
  p.clamp_intensity = fp[103];
  p.confidence_power = fp[104];
  p.inv_w = fp[105];
  p.inv_fh = fp[106];
  for (int k = 0; k < 4; ++k) {
    p.div[k] = fp[107 + k];
    p.inv_div[k] = fp[111 + k];
  }
  p.h = ip[0];
  p.w = ip[1];
  p.fh = ip[2];
  p.row_offset = ip[3];
  p.n_slots = ip[4];
  p.spec_mask = ip[5];
  p.gate = ip[6];
  p.log_transform = ip[7];
  p.dilation = ip[8];
  p.perspective = ip[9];
  p.recip = ip[10];
  p.pow_law = ip[11];
  p.ray_stride = ip[12];
  p.rough_stride = ip[13];
}

}  // namespace

// ---- host entry point ----
// stage 0: the prepare kernel, 1: the blend kernel. ptrs (host): the
// device pointers of ReprojectPlanes in its order of declaration (null
// where unused), the per-slot arrays kMaxSlots long. iparams (host): h,
// w, frame height, row offset, slots, specular slot mask, the gate of
// the roughness-limited blend, log transform, dilation, perspective,
// recip, pow law, ray and roughness strides. fparams (host): the six
// matrices (16 floats each, row-major), the camera position, the depth
// law's three constants, max_value, the clamp intensity, the confidence
// power, 1 / w, 1 / frame height, the four divisors and their
// reciprocals.
extern "C" int re_reproject(int stage, const void* const* ptrs, const int* iparams,
                            const float* fparams, void* stream) {
  ReprojectParams p;
  unpack(iparams, fparams, p);
  if (stage < 0 || stage > 1 || p.h < 0 || p.w < 0 || p.fh < 1 || p.n_slots < 1 ||
      p.n_slots > kMaxSlots || (p.spec_mask >> p.n_slots) != 0) {
    return cudaErrorInvalidValue;
  }
  if (p.h == 0 || p.w == 0) return cudaSuccess;
  ReprojectPlanes q;
  const void* const* a = ptrs;
  q.vel = static_cast<const float*>(*a++);
  q.normal = static_cast<const float*>(*a++);
  q.depth = static_cast<const float*>(*a++);
  q.last_normal = static_cast<const float*>(*a++);
  q.last_depth = static_cast<const float*>(*a++);
  q.ray = static_cast<const float*>(*a++);
  q.rough = static_cast<const float*>(*a++);
  for (int s = 0; s < kMaxSlots; ++s) q.history[s] = static_cast<const float*>(*a++);
  for (int s = 0; s < kMaxSlots; ++s) q.input[s] = static_cast<const float*>(*a++);
  for (int k = 0; k < 2; ++k) q.probe_nd[k] = static_cast<const float*>(*a++);
  for (int k = 0; k < 2; ++k) q.probe_ok[k] = static_cast<const uint8_t*>(*a++);
  for (int s = 0; s < kMaxSlots; ++s) q.fetched[s] = static_cast<const float*>(*a++);
  for (int s = 0; s < kMaxSlots; ++s) q.box_min2[s] = static_cast<const float*>(*a++);
  for (int s = 0; s < kMaxSlots; ++s) q.box_max2[s] = static_cast<const float*>(*a++);
  for (int s = 0; s < kMaxSlots; ++s) q.box_min1[s] = static_cast<const float*>(*a++);
  for (int s = 0; s < kMaxSlots; ++s) q.box_max1[s] = static_cast<const float*>(*a++);
  q.nd = static_cast<float*>(const_cast<void*>(*a++));
  q.targets = static_cast<int*>(const_cast<void*>(*a++));
  q.fracs = static_cast<float*>(const_cast<void*>(*a++));
  for (int s = 0; s < kMaxSlots; ++s) q.history16[s] = static_cast<float*>(const_cast<void*>(*a++));
  for (int s = 0; s < kMaxSlots; ++s) q.out[s] = static_cast<float*>(const_cast<void*>(*a++));
  const dim3 block(kBX, kBY);
  const dim3 grid((p.w + kBX - 1) / kBX, (p.h + kBY - 1) / kBY);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stage == 0) {
    reproject_prepare_kernel<<<grid, block, 0, st>>>(p, q);
  } else {
    reproject_blend_kernel<<<grid, block, 0, st>>>(p, q);
  }
  return cudaGetLastError();
}
