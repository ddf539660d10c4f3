// Fused HBAO (`hbao.frag:80-115`, `hbao_utils.glsl:21-62`): per pixel,
// reconstruct the world position, draw spp cosine-weighted directions
// from the blue-noise tile, project each sample, fetch its depth
// (nearest, window-clamped), and integrate the horizon occlusion.
//
// Replaces ops/pallas/hbao.py::_hbao_kernel (hbao_fused). Semantics
// kept: the two-step screen->world transform_point; the basis
// b = normalize(cross(n, (0,1,1))), t = cross(b, n) with rsqrt; the
// sample distance distance * u2^(power+1) as exp(log(u2) * (power+1));
// non-finite sample uvs set to 0 before the integer cast; the sample
// target clamped to +-ky rows / +-kx columns around the pixel (this
// bounds the sampling radius in screen space) after the frame clamp.
// Noise of sample s is tile[(y + sy_s) % 128, (x + sx_s) % 128],
// channels 0..2, with the shifts computed on the host. A row block of a
// larger frame (the row-sharded route: a shard extended by halo rows)
// passes the global row of its first row, row0, and the global rows hg:
// the uv, the sample row and its frame clamp are the global frame's, the
// target is re-based by -row0 and held to the block, and the host rolls
// the noise shifts by row0. With row0 = 0 and hg = h this is the
// unsharded kernel.
//
// On the H100 this kernel is bound by instruction issue, not bytes (20
// bytes a pixel). A sample's cosine draw (sqrt, sin, cos, sqrt and
// exp(log) of libm) depends on its tile texel and two launch constants
// only, and drawing it per sample more than doubled the loop's
// instructions. Design: a noise table. hbao_noise_kernel
// computes, once per tile texel, the float4 (k1, k2, k3, dist) with the
// same expressions and libm calls, so each value is the same function of
// the same bits (the wrapper keeps the 256 KB table per distance and
// power, so a frame launches nothing more); the per-sample loop reads one
// float4 of it at the texel it read before (L2 holds it, a warp reads 512
// consecutive bytes) and keeps the rest in its order: the basis products,
// rsqrt, the projection with its two IEEE divisions, the clamps, the
// depth fetch, the integral. A background pixel (depth >= 1), whose AO
// is 1 whatever its samples, stops after its depth load (a fifth of the
// flagship frame; its carry is never read). One thread per pixel,
// everything in registers, 128 x 1 blocks (2D blocks, whose rows share
// the sample-depth gathers' L1 lines, measured no faster), held to 10
// blocks an SM: the row offset's bounds took 50 registers, which the
// allocation step of 8 makes 56 and 9 blocks, 3% slower.
// No window limit: the TPU's ky <= 64, kx <= 32 came from VMEM blocks
// and lane groups. Any spp: the noise shifts travel in the launch's
// parameters, kChunk samples a launch; above kChunk the entry point
// launches once a chunk, and each launch carries the running ao and
// weight sums to the next through a (2, h, w) scratch in device memory,
// so the samples are summed in the same order as in one launch.
#include "common.cuh"

namespace {

using re::clampi;

constexpr int kChunk = 32;  // samples a launch
constexpr float kPi2 = 6.2831855f;  // float32(2 * pi)

struct HbaoParams {
  float pmi[16];   // projection_matrix_inverse, row-major
  float cmw[16];   // camera_matrix_world
  float pv[16];    // projection_view_matrix
  float cpos[3];   // camera position
  float bias;      // bias (scaled by 1000 in the kernel)
  float th;        // thickness * 0.01
  float inv_w;     // float32(1 / W)
  float inv_h;     // float32(1 / H), H the global rows
  int row0;       // global row of the block's row 0
  int hg;         // global rows
  int t_lo, t_hi;  // a sample's block row: in the frame and in the block
  int n;          // samples of this launch, at most kChunk
  int first;      // 1: the sums start at 0, else from the carry
  int last;       // 1: write the AO, else the sums to the carry
  int sy[kChunk];
  int sx[kChunk];
};

__device__ __forceinline__ void tpoint(const float* m, float x, float y,
                                       float z, float& ox, float& oy,
                                       float& oz) {
  const float r0 = m[0] * x + m[1] * y + m[2] * z + m[3];
  const float r1 = m[4] * x + m[5] * y + m[6] * z + m[7];
  const float r2 = m[8] * x + m[9] * y + m[10] * z + m[11];
  const float r3 = m[12] * x + m[13] * y + m[14] * z + m[15];
  ox = r0 / r3;
  oy = r1 / r3;
  oz = r2 / r3;
}

// One float4 per blue-noise texel: (k1, k2, k3, dist) of the cosine
// draw, r = sqrt(u0), theta = 2 pi u1: k1 = r sin(theta), k2 =
// sqrt(max(1 - u0, 0)), k3 = r cos(theta), dist = distance * u2^pow1.
__global__ void hbao_noise_kernel(const float* __restrict__ tile,
                                  re::F4* __restrict__ table, float dist_k,
                                  float pow1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 128 * 128) return;
  const float u0 = tile[4 * i];
  const float u1 = tile[4 * i + 1];
  const float u2 = tile[4 * i + 2];
  const float r_ = sqrtf(u0);
  const float theta = u1 * kPi2;
  re::F4 v;
  v.v[0] = r_ * sinf(theta);
  v.v[1] = sqrtf(fmaxf(1.0f - u0, 0.0f));
  v.v[2] = r_ * cosf(theta);
  v.v[3] = dist_k * re::pow_el(u2, pow1);
  table[i] = v;
}

__global__ void __launch_bounds__(128, 10) hbao_kernel(const float* __restrict__ depth,
                            const float* __restrict__ normal,
                            const re::F4* __restrict__ noise,
                            float* __restrict__ ao_out,
                            float* __restrict__ carry, int h, int w, int ky,
                            int kx, const HbaoParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const int pix = y * w + x;
  const float d = depth[pix];
  if (d >= 1.0f) {  // background: its AO is 1 whatever its samples
    if (p.last) ao_out[pix] = 1.0f;
    return;
  }
  const float uvx = (static_cast<float>(x) + 0.5f) * p.inv_w;
  const int yg = y + p.row0;
  const float uvy = (static_cast<float>(yg) + 0.5f) * p.inv_h;
  float cx, cy, cz, wpx, wpy, wpz;
  tpoint(p.pmi, (uvx - 0.5f) * 2.0f, (uvy - 0.5f) * 2.0f, (d - 0.5f) * 2.0f,
         cx, cy, cz);
  tpoint(p.cmw, cx, cy, cz, wpx, wpy, wpz);

  const float nx = normal[3 * pix];
  const float ny = normal[3 * pix + 1];
  const float nz = normal[3 * pix + 2];
  const float bias_k = p.bias * 1000.0f;
  // b = normalize(cross(n, (0, 1, 1))), t = cross(b, n)
  float bx = ny - nz;
  float by = -nx;
  float bz = nx;
  const float binv = rsqrtf(bx * bx + by * by + bz * bz);
  bx = bx * binv;
  by = by * binv;
  bz = bz * binv;
  const float tx_ = by * nz - bz * ny;
  const float ty_ = bz * nx - bx * nz;
  const float tz_ = bx * ny - by * nx;

  // a sample row's offset bounds: its block row within the frame and
  // within the block (the block's bind only on a block's halo rows)
  const int dy_lo = p.t_lo - y;
  const int dy_hi = p.t_hi - y;
  const size_t hw = static_cast<size_t>(h) * w;
  float ao = p.first ? 0.0f : carry[pix];
  float tw = p.first ? 0.0f : carry[hw + pix];
  for (int s = 0; s < p.n; ++s) {
    const re::F4 u = noise[((y + p.sy[s]) & 127) * 128 + ((x + p.sx[s]) & 127)];
    const float k1 = u.v[0];
    const float k2 = u.v[1];
    const float k3 = u.v[2];
    float dx_ = k1 * bx + k2 * nx + k3 * tx_;
    float dy_ = k1 * by + k2 * ny + k3 * ty_;
    float dz_ = k1 * bz + k2 * nz + k3 * tz_;
    const float dinv = rsqrtf(dx_ * dx_ + dy_ * dy_ + dz_ * dz_);
    dx_ = dx_ * dinv;
    dy_ = dy_ * dinv;
    dz_ = dz_ * dinv;

    const float dist = u.v[3];
    const float spx = wpx + dist * dx_;
    const float spy = wpy + dist * dy_;
    const float spz = wpz + dist * dz_;
    const float cxv = p.pv[0] * spx + p.pv[1] * spy + p.pv[2] * spz + p.pv[3];
    const float cyv = p.pv[4] * spx + p.pv[5] * spy + p.pv[6] * spz + p.pv[7];
    const float cwv = p.pv[12] * spx + p.pv[13] * spy + p.pv[14] * spz + p.pv[15];
    const float safe_w = fabsf(cwv) > 1e-8f ? cwv : 1e-8f;
    float sux = cxv / safe_w * 0.5f + 0.5f;
    float suy = cyv / safe_w * 0.5f + 0.5f;
    // a degenerate direction gives NaN; its fetch index must stay in range
    sux = (sux == sux) ? fminf(fmaxf(sux, -2.0f), 3.0f) : 0.0f;
    suy = (suy == suy) ? fminf(fmaxf(suy, -2.0f), 3.0f) : 0.0f;
    const int ixt = static_cast<int>(floorf(sux * static_cast<float>(w)));
    const int iyt = static_cast<int>(floorf(suy * static_cast<float>(p.hg))) - p.row0;
    const int dyv = clampi(clampi(clampi(iyt - y, -ky, ky), dy_lo, dy_hi), -ky, ky);
    const int dxk = clampi(clampi(ixt, 0, w - 1) - x, -kx, kx);
    const float sd = depth[(y + dyv) * w + x + dxk];

    const float theta_n = nx * dx_ + ny * dy_ + nz * dz_;
    const float ddx = spx - p.cpos[0];
    const float ddy = spy - p.cpos[1];
    const float ddz = spz - p.cpos[2];
    const float dd = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
    const float delta = (d - sd) * 0.001f * dd * dd;
    tw = tw + theta_n;
    const float horizon = sd + delta * bias_k;
    float occl = fmaxf(0.0f, horizon - d) * theta_n;
    const float m = fmaxf(0.0f, 1.0f - delta / p.th);
    occl = sqrtf(fmaxf(10.0f * occl * m / fmaxf(dd, 1e-6f), 0.0f));
    ao = ao + (delta < p.th ? occl : 0.0f);
  }
  if (!p.last) {
    carry[pix] = ao;
    carry[hw + pix] = tw;
    return;
  }
  ao = tw > 0.0f ? ao / tw : ao;
  ao = fminf(fmaxf(1.0f - ao, 0.0f), 1.0f);
  ao_out[pix] = ao;
}

}  // namespace

// ---- host entry points ----
// The noise table of hbao_kernel: tile (128, 128, 4) float32, table
// (128, 128, 4) float32; kparams (host): distance, distance_power + 1.
extern "C" int re_hbao_noise(const float* tile, float* table,
                             const float* kparams, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  hbao_noise_kernel<<<128, 128, 0, st>>>(
      tile, reinterpret_cast<re::F4*>(table), kparams[0], kparams[1]);
  return cudaGetLastError();
}

// noise: the table of re_hbao_noise (16-byte aligned); fparams (host):
// pmi[16] cmw[16] pv[16] cpos[3] dist pow1 bias th inv_w inv_h (dist and
// pow1 are in the table; inv_h of the global rows hg); shifts (host):
// sy[spp] then sx[spp], rolled by row0; carry: (2, h, w) float32
// scratch, needed (and only read or written) when spp > 32; row0: the
// global row of the block's row 0.
extern "C" int re_hbao(const float* depth, const float* normal,
                       const float* noise, float* ao, float* carry, int h,
                       int w, int ky, int kx, int spp, int row0, int hg,
                       const float* fparams, const int* shifts, void* stream) {
  if (spp < 1 || (spp > kChunk && carry == nullptr) || hg < 1 ||
      reinterpret_cast<uintptr_t>(noise) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  HbaoParams p;
  const float* f = fparams;
  for (int i = 0; i < 16; ++i) p.pmi[i] = *f++;
  for (int i = 0; i < 16; ++i) p.cmw[i] = *f++;
  for (int i = 0; i < 16; ++i) p.pv[i] = *f++;
  for (int i = 0; i < 3; ++i) p.cpos[i] = *f++;
  f += 2;  // dist, pow1
  p.bias = *f++;
  p.th = *f++;
  p.inv_w = *f++;
  p.inv_h = *f++;
  p.row0 = row0;
  p.hg = hg;
  p.t_lo = max(0, -row0);
  p.t_hi = min(h - 1, hg - 1 - row0);
  const dim3 block(128);
  const dim3 grid((w + 127) / 128, h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int s0 = 0; s0 < spp; s0 += kChunk) {
    p.n = spp - s0 < kChunk ? spp - s0 : kChunk;
    p.first = s0 == 0;
    p.last = s0 + kChunk >= spp;
    for (int s = 0; s < kChunk; ++s) {
      p.sy[s] = s < p.n ? shifts[s0 + s] : 0;
      p.sx[s] = s < p.n ? shifts[spp + s0 + s] : 0;
    }
    hbao_kernel<<<grid, block, 0, st>>>(
        depth, normal, reinterpret_cast<const re::F4*>(noise), ao, carry, h, w,
        ky, kx, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
