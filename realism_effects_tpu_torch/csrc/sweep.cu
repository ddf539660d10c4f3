// SSGI sweep march: for each pixel and each of n_rays rays, the first
// step along the ray's own direction bin at which the depth buffer lies
// within [0, thickness) in front of the ray, and the prewarped radiance
// at that texel. Below it, the reference's per-pixel march
// (ray_march_kernel), the other of SSGI's and SSR's two traces.
//
// Replaces ops/pallas/sweep.py::_sweep_kernel (sweep_march_vmem), whose
// semantics are the jnp executor's (ops/ssgi_sweep.py:264-313). A ray in
// bin d takes step k of the table row d: texel offset (dy, dx) and
// screen distance s. The step is live when the texel is in the frame,
// denom = k_len - s * rwd > EPS, t_s = s * p2 / denom lies in
// [0, ray_distance] and s <= s_end; it hits when z_d - (z0 + t_s * lz)
// lies in [0, thickness). The first hit records (s, radii_prev[k], z_d)
// and the radiance there; with miss_gi the radiance follows every live
// step until the hit, so a missed ray ends with its march-end texel's.
// A bin outside [0, dirs), or not an integer (a NaN plane), never
// matches.
//
// The TPU kernel evaluated all bins at every radius over a whole row slab
// held in VMEM and selected each pixel's own bin; on the H100 a thread
// per pixel walks its own bin only and ends at its hit. The first such
// kernel (128 x 1 blocks, the table as (dirs * steps, 3) floats) was not
// bound by bytes but by shared-memory bank conflicts: row d started at
// float d * steps * 3, a multiple of the 32 banks at 32 steps, so the
// lanes of a warp, in different bins at the same step, read one bank at
// different addresses, and each of the three table loads of a step
// replayed once per distinct bin of the warp. Design: the host packs the
// table into one 16-byte record a step, (dy, dx) already truncated to
// int32, s and radii_prev[k], in rows of an odd stride (steps rounded up
// to odd), so one 128-bit load a step reads it and lanes in distinct
// bins at the same step fall in distinct bank groups. A step's cheap
// tests (in the frame, s <= s_end, denom > EPS) come before its IEEE
// division, and its depth fetch goes out before the division, so the
// two overlap. The radiance is read once a ray, at the last texel the
// walk recorded, not at every live step. Blocks are 32 x 4 pixels. What
// is left is issue: most rays miss and walk all their steps, more than
// half the steps walked are live, and a live step costs some 45
// instructions, the division's among them (chip_smoke.py prints the
// shares). Sorting a tile's rays by bin would make a warp's lanes agree
// on liveness only a little more often; fetching the next step's depth
// a step ahead cost more than it hid.
// The table sits in shared memory up to the card's opt-in limit (227 KB
// on the H100; above 48 KB through the dynamic shared-memory opt-in); a
// larger table is read from device memory by the same code. The
// operation order of _t_of_s (ops/ssgi_sweep.py:90-98), the IEEE
// division and the hit law are kept, so the result equals the plain
// version bit for bit.
#include "common.cuh"

namespace {

constexpr float kEps = 1e-6f;
constexpr int kPlanesPerRay = 6;  // k_len, p2, rwd, lz, bin, s_end
constexpr int kBX = 32;           // block: 32 x 4 pixels, one a thread
constexpr int kBY = 4;

// One step of the packed table.
struct alignas(16) Step {
  int dy, dx;
  float s, s_lo;
};

struct SweepParams {
  float thickness, ray_distance;
  int h, w, n_rays, dirs, steps, stride, miss_gi;
};

// z_tex (h, w) view z; rad (h, w) texels of 4 float16 (8 bytes) or null;
// planes (1 + 6 * n_rays, h, w); table (dirs, stride) Steps, of which
// the first `steps` of each row are used. Out per ray: hit (h, w) u8,
// fout (3, h, w) [s_hit, s_lo, z_d_hit], gi (h, w) texels.
template <bool kShared>
__global__ void __launch_bounds__(kBX * kBY)
sweep_kernel(const float* __restrict__ z_tex, const uint64_t* __restrict__ rad,
             const float* __restrict__ planes, const Step* __restrict__ table,
             uint8_t* __restrict__ hit_out, float* __restrict__ fout,
             uint64_t* __restrict__ gi_out, SweepParams p) {
  const Step* tab = table;
  if constexpr (kShared) {
    RE_DYNAMIC_SHARED(Step, s_tab);
    re::block_load(reinterpret_cast<float*>(s_tab),
                   reinterpret_cast<const float*>(table), p.dirs * p.stride * 4);
    tab = s_tab;
  }

  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= p.w || y >= p.h) return;
  const size_t hw = static_cast<size_t>(p.h) * p.w;
  const size_t pix = static_cast<size_t>(y) * p.w + x;
  const float z0 = planes[pix];

  for (int r = 0; r < p.n_rays; ++r) {
    const float* pl = planes + (1 + kPlanesPerRay * r) * hw + pix;
    const float k_len = pl[0];
    const float p2 = pl[hw];
    const float rwd = pl[2 * hw];
    const float lz = pl[3 * hw];
    const float bin = pl[4 * hw];
    const float s_end = pl[5 * hw];

    bool hit = false;
    float s_hit = 0.0f, s_lo = 0.0f, z_d_hit = 0.0f;
    size_t q_gi = hw;  // the texel whose radiance the ray returns; none
    if (bin >= 0.0f && bin < static_cast<float>(p.dirs) && bin == floorf(bin)) {
      const Step* row = tab + static_cast<int>(bin) * p.stride;
      for (int k = 0; k < p.steps; ++k) {
        const Step e = row[k];
        const int yy = y + e.dy;
        const int xx = x + e.dx;
        if (yy < 0 || yy >= p.h || xx < 0 || xx >= p.w) continue;
        // _t_of_s (ops/ssgi_sweep.py:90-98) in its operation order; the
        // cheap tests first, and with denom > EPS its safe denominator is
        // denom itself. The depth fetch goes out before the division.
        const float s = e.s;
        const float denom = k_len - s * rwd;
        if (!(s <= s_end && denom > kEps)) continue;
        const size_t q = static_cast<size_t>(yy) * p.w + xx;
        const float z_d = z_tex[q];
        const float t_s = s * p2 / denom;
        if (!(t_s >= 0.0f && t_s <= p.ray_distance)) continue;
        const float diff = z_d - (z0 + t_s * lz);
        const bool cond = diff >= 0.0f && diff < p.thickness;
        if (cond || p.miss_gi) q_gi = q;
        if (cond) {
          hit = true;
          s_hit = s;
          s_lo = e.s_lo;
          z_d_hit = z_d;
          break;
        }
      }
    }
    hit_out[r * hw + pix] = hit ? 1 : 0;
    float* fo = fout + 3 * r * hw + pix;
    fo[0] = s_hit;
    fo[hw] = s_lo;
    fo[2 * hw] = z_d_hit;
    if (gi_out != nullptr) gi_out[r * hw + pix] = q_gi < hw ? rad[q_gi] : 0;
  }
}

template <bool kShared>
int launch(const float* z_tex, const uint64_t* rad, const float* planes,
           const Step* table, uint8_t* hit, float* fout, uint64_t* gi,
           size_t smem, const SweepParams& p, cudaStream_t st) {
  if (kShared && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 block(kBX, kBY);
  const dim3 grid((p.w + kBX - 1) / kBX, (p.h + kBY - 1) / kBY);
  sweep_kernel<kShared><<<grid, block, kShared ? smem : 0, st>>>(
      z_tex, rad, planes, table, hit, fout, gi, p);
  return cudaGetLastError();
}

// ---- the per-pixel march: ops/ssgi.py::view_space_ray_march ----
// RayMarch + BinarySearch (ssgi.frag:441-503), one thread a lane (a
// pixel's ray), with the plain route's operations in its order: steps
// 1 .. steps - 1 of step_dir = l * (ray_distance / steps), each eased by
// 1 - exp(-0.25 x^2), x = (i + random_b) - 0.5; the view position
// projected to uv (rows 0, 1 and 3 of the projection, summed left to
// right), the nearest depth texel through sample_nearest's floor and
// clamp, depth_to_view_z, and the hit test 0 <= diff < thickness. The
// plain route holds a lane's position once it has hit and goes on
// stepping it; nothing it computes after the hit changes the lane's
// result, so the thread stops there. A hit lane then takes refine_steps
// bisections from half a step back; a missed lane returns the uv of its
// last step and the 1e9 sentinel. The same operations in the same order
// as the plain route (-fmad=false), so on the card the two agree bit for
// bit: expf is the one libm call, the same on both.
//
// The TPU never had a kernel for it (the JAX package marches in XLA);
// the plain route is some 30 whole-frame torch operations a step, about
// 750 launches a ray. Bound on the H100 by bytes: the lane's view
// position, ray, random number and its three outputs once, the depth
// texture once (its texels are re-read from L1 and L2: a ray's steps
// stay near the pixel, and a warp's 32 lanes are neighbours).

constexpr int kMarchBlock = 256;

struct MarchParams {
  float m[3][4];      // rows 0, 1 and 3 of the projection matrix
  float step_scale;   // ray_distance / steps, rounded to float32
  float thickness;
  // perspective: near * far, far - near, far; orthographic: near - far, near
  float z0, z1, z2;
  int perspective;
  int n, dh, dw, steps, refine_steps;
  long long rb_stride;  // elements between two lanes' random numbers
};

// math3d.view_to_screen: (xy / w) * 0.5 + 0.5 of the projected point.
__device__ __forceinline__ void to_screen(const MarchParams& p, float x, float y,
                                          float z, float& u, float& v) {
  const float cx = p.m[0][0] * x + p.m[0][1] * y + p.m[0][2] * z + p.m[0][3];
  const float cy = p.m[1][0] * x + p.m[1][1] * y + p.m[1][2] * z + p.m[1][3];
  const float cw = p.m[2][0] * x + p.m[2][1] * y + p.m[2][2] * z + p.m[2][3];
  u = cx / cw * 0.5f + 0.5f;
  v = cy / cw * 0.5f + 0.5f;
}

// depth_to_view_z(sample_nearest(depth, uv)).
__device__ __forceinline__ float view_z_at(const float* __restrict__ depth,
                                           const MarchParams& p, float u, float v) {
  const int ix = re::clampi(re::floor_int(u * static_cast<float>(p.dw)), 0, p.dw - 1);
  const int iy = re::clampi(re::floor_int(v * static_cast<float>(p.dh)), 0, p.dh - 1);
  const float d = depth[static_cast<size_t>(iy) * p.dw + ix];
  return p.perspective ? p.z0 / (d * p.z1 - p.z2) : d * p.z0 - p.z1;
}

__global__ void __launch_bounds__(kMarchBlock)
ray_march_kernel(const float* __restrict__ view_pos, const float* __restrict__ ray,
                 const float* __restrict__ random_b, const float* __restrict__ depth,
                 float* __restrict__ uv_out, float* __restrict__ pos_out,
                 uint8_t* __restrict__ missed_out, const MarchParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * kMarchBlock + threadIdx.x;
  if (i >= p.n) return;
  float hx = view_pos[3 * i], hy = view_pos[3 * i + 1], hz = view_pos[3 * i + 2];
  const float sx = ray[3 * i] * p.step_scale;
  const float sy = ray[3 * i + 1] * p.step_scale;
  const float sz = ray[3 * i + 2] * p.step_scale;
  const float rb = random_b[i * p.rb_stride];
  float u, v;
  to_screen(p, hx, hy, hz, u, v);
  bool hit = false;
  for (int k = 1; k < p.steps && !hit; ++k) {
    const float x = (static_cast<float>(k) + rb) - 0.5f;
    const float cs = 1.0f - expf(x * x * -0.25f);
    hx = hx + sx * cs;
    hy = hy + sy * cs;
    hz = hz + sz * cs;
    to_screen(p, hx, hy, hz, u, v);
    const float diff = view_z_at(depth, p, u, v) - hz;
    hit = diff >= 0.0f && diff < p.thickness;
  }
  if (hit && p.refine_steps > 0) {
    float bx = sx * 0.5f, by = sy * 0.5f, bz = sz * 0.5f;
    hx = hx - bx;
    hy = hy - by;
    hz = hz - bz;
    for (int k = 0; k < p.refine_steps; ++k) {
      float bu, bv;
      to_screen(p, hx, hy, hz, bu, bv);
      const float diff = view_z_at(depth, p, bu, bv) - hz;
      bx = bx * 0.5f;
      by = by * 0.5f;
      bz = bz * 0.5f;
      if (diff >= 0.0f) {
        hx = hx - bx;
        hy = hy - by;
        hz = hz - bz;
      } else {
        hx = hx + bx;
        hy = hy + by;
        hz = hz + bz;
      }
    }
    to_screen(p, hx, hy, hz, u, v);
  }
  uv_out[2 * i] = u;
  uv_out[2 * i + 1] = v;
  pos_out[3 * i] = hit ? hx : 1.0e9f;
  pos_out[3 * i + 1] = hit ? hy : 1.0e9f;
  pos_out[3 * i + 2] = hit ? hz : 1.0e9f;
  missed_out[i] = hit ? 0 : 1;
}

}  // namespace

// ---- host entry point ----
// table: (dirs, stride) packed Steps (int32 dy, int32 dx, float s, float
// radii_prev[k]), stride >= steps; fparams (host): thickness,
// ray_distance. rad and gi are both null for a march without radiance.
extern "C" int re_sweep(const float* z_tex, const void* rad,
                        const float* planes, const void* table,
                        uint8_t* hit, float* fout, void* gi, int h, int w,
                        int n_rays, int dirs, int steps, int stride,
                        int miss_gi, const float* fparams, void* stream) {
  if (n_rays < 1 || dirs < 1 || steps < 1 || stride < steps ||
      (rad == nullptr) != (gi == nullptr)) {
    return cudaErrorInvalidValue;
  }
  SweepParams p;
  p.thickness = fparams[0];
  p.ray_distance = fparams[1];
  p.h = h;
  p.w = w;
  p.n_rays = n_rays;
  p.dirs = dirs;
  p.steps = steps;
  p.stride = stride;
  p.miss_gi = miss_gi;
  const size_t smem = static_cast<size_t>(dirs) * stride * sizeof(Step);
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  const auto* zr = static_cast<const uint64_t*>(rad);
  const auto* tb = static_cast<const Step*>(table);
  auto* go = static_cast<uint64_t*>(gi);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem <= static_cast<size_t>(optin)) {
    return launch<true>(z_tex, zr, planes, tb, hit, fout, go, smem, p, st);
  }
  return launch<false>(z_tex, zr, planes, tb, hit, fout, go, smem, p, st);
}

// view_pos, ray: (n, 3) float32; random_b: lane i at random_b[i *
// rb_stride]; depth: (dh, dw) float32. Out: uv (n, 2), hit_pos (n, 3)
// float32, missed (n) bytes. fparams (host): the projection's rows 0, 1
// and 3 (12 floats), step_scale, thickness, then the depth law's three
// constants (see MarchParams).
extern "C" int re_ray_march(const float* view_pos, const float* ray,
                            const float* random_b, const float* depth, float* uv,
                            float* hit_pos, uint8_t* missed, int n, int dh, int dw,
                            int steps, int refine_steps, int perspective,
                            int rb_stride, const float* fparams, void* stream) {
  if (n < 0 || dh < 1 || dw < 1 || steps < 1 || refine_steps < 0 || rb_stride < 1) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  MarchParams p;
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 4; ++c) p.m[r][c] = fparams[4 * r + c];
  }
  p.step_scale = fparams[12];
  p.thickness = fparams[13];
  p.z0 = fparams[14];
  p.z1 = fparams[15];
  p.z2 = fparams[16];
  p.perspective = perspective;
  p.n = n;
  p.dh = dh;
  p.dw = dw;
  p.steps = steps;
  p.refine_steps = refine_steps;
  p.rb_stride = rb_stride;
  const dim3 grid((n + kMarchBlock - 1) / kMarchBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ray_march_kernel<<<grid, kMarchBlock, 0, st>>>(view_pos, ray, random_b, depth, uv,
                                                 hit_pos, missed, p);
  return cudaGetLastError();
}
