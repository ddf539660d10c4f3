// SSGI sweep march: for each pixel and each of n_rays rays, the first
// step along the ray's own direction bin at which the depth buffer lies
// within [0, thickness) in front of the ray, and the prewarped radiance
// at that texel.
//
// Replaces ops/pallas/sweep.py::_sweep_kernel (sweep_march_vmem), whose
// semantics are the jnp executor's (ops/ssgi_sweep.py:264-313). A ray in
// bin d takes step k of the table row d * steps + k: texel offset
// (dy, dx) and screen distance s. The step is live when the texel is in
// the frame, denom = k_len - s * rwd > EPS, t_s = s * p2 / denom lies in
// [0, ray_distance] and s <= s_end; it hits when z_d - (z0 + t_s * lz)
// lies in [0, thickness). The first hit records (s, radii_prev[k], z_d)
// and the radiance there; with miss_gi the radiance follows every live
// step until the hit, so a missed ray ends with its march-end texel's.
// A bin outside [0, dirs), or not an integer (a NaN plane), never
// matches.
//
// The TPU kernel evaluated all bins at every radius over a whole row slab
// held in VMEM and selected each pixel's own bin; on the H100 a thread
// per pixel walks its own bin only, ends at its hit, and reads just the
// texels it needs (most of z and radiance, 25 MB at 1080p, stay in the
// 50 MB L2). The (dirs * steps, 3) table and the radii sit in shared
// memory: the bins of a warp's pixels differ, so __constant__ reads would
// serialise. Bound by bytes: the 13 planes in, 12 B of floats + 1 B
// flag + 8 B radiance a ray out.
#include "common.cuh"

namespace {

constexpr float kEps = 1e-6f;
constexpr int kPlanesPerRay = 6;  // k_len, p2, rwd, lz, bin, s_end

struct SweepParams {
  float thickness, ray_distance;
  int h, w, n_rays, dirs, steps, miss_gi;
};

// z_tex (h, w) view z; rad (h, w) texels of 4 float16 (8 bytes) or null;
// planes (1 + 6 * n_rays, h, w); table: (dirs * steps, 3) (dy, dx, s)
// then radii_prev (steps). Out per ray: hit (h, w) u8, fout (3, h, w)
// [s_hit, s_lo, z_d_hit], gi (h, w) texels.
__global__ void sweep_kernel(const float* __restrict__ z_tex,
                             const uint64_t* __restrict__ rad,
                             const float* __restrict__ planes,
                             const float* __restrict__ table,
                             uint8_t* __restrict__ hit_out,
                             float* __restrict__ fout,
                             uint64_t* __restrict__ gi_out, SweepParams p) {
  RE_DYNAMIC_SHARED(float, tab);
  const int n_tab = p.dirs * p.steps * 3;
  re::block_load(tab, table, n_tab + p.steps);
  const float* radii_prev = tab + n_tab;

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= p.w) return;
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
    uint64_t gi = 0;
    if (bin >= 0.0f && bin < static_cast<float>(p.dirs) && bin == floorf(bin)) {
      const float* row = tab + static_cast<int>(bin) * p.steps * 3;
      for (int k = 0; k < p.steps; ++k) {
        const int yy = y + static_cast<int>(row[3 * k]);
        const int xx = x + static_cast<int>(row[3 * k + 1]);
        if (yy < 0 || yy >= p.h || xx < 0 || xx >= p.w) continue;
        const float s = row[3 * k + 2];
        // _t_of_s (ops/ssgi_sweep.py:90-98), in its operation order
        const float denom = k_len - s * rwd;
        const float t_s = s * p2 / (fabsf(denom) > kEps ? denom : kEps);
        if (!(denom > kEps && t_s >= 0.0f && t_s <= p.ray_distance &&
              s <= s_end)) {
          continue;
        }
        const size_t q = static_cast<size_t>(yy) * p.w + xx;
        const float z_d = z_tex[q];
        const float diff = z_d - (z0 + t_s * lz);
        const bool cond = diff >= 0.0f && diff < p.thickness;
        if (rad != nullptr && (cond || p.miss_gi)) gi = rad[q];
        if (cond) {
          hit = true;
          s_hit = s;
          s_lo = radii_prev[k];
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
    if (gi_out != nullptr) gi_out[r * hw + pix] = gi;
  }
}

}  // namespace

// ---- host entry point ----
// fparams (host): thickness, ray_distance. rad and gi are both null for
// a march without radiance.
extern "C" int re_sweep(const float* z_tex, const void* rad,
                        const float* planes, const float* table,
                        uint8_t* hit, float* fout, void* gi, int h, int w,
                        int n_rays, int dirs, int steps, int miss_gi,
                        const float* fparams, void* stream) {
  const size_t smem = (static_cast<size_t>(dirs) * steps * 3 + steps) * sizeof(float);
  if (n_rays < 1 || dirs < 1 || steps < 1 || smem > 48 * 1024 ||
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
  p.miss_gi = miss_gi;
  const dim3 block(128);
  const dim3 grid((w + 127) / 128, h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sweep_kernel<<<grid, block, smem, st>>>(
      z_tex, static_cast<const uint64_t*>(rad), planes, table, hit, fout,
      static_cast<uint64_t*>(gi), p);
  return cudaGetLastError();
}
