// SSGI sweep march: for each pixel and each of n_rays rays, the first
// step along the ray's own direction bin at which the depth buffer lies
// within [0, thickness) in front of the ray, and the prewarped radiance
// at that texel.
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
