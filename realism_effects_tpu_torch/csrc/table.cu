// Per-face record fetch: for each pixel's winning face id, the K floats
// of that face's packed record.
//
// Replaces ops/pallas/table.py::_lookup_kernel (vmem_table_lookup),
// which computes tab[clip(iy), clip(ix)] over (rows, 128, <= 8) chunks of
// the record with iy = max(id, 0) // 128 and ix = max(id, 0) % 128; the
// chunks concatenate to the whole record, so one launch serves all of
// them. The TPU kernel resolved the fetch as a dense select over every
// table row (a gather is priced per index there) and was gated to
// tables of <= 64 rows; here the table (at most a few MB, in L2) is read
// directly, for any table size. A copy: it equals advanced indexing bit
// for bit.
//
// On the H100 the fetch is bound by bytes (4 B of id in and 4 K B of
// record out a pixel), but the first version, a thread per output float,
// was bound by issue: each thread divided its 64-bit index by the
// run-time K (a software routine of some 70 instructions), re-read its
// pixel's id and re-derived the record's row and lane, and moved 4 bytes.
// Design: a block owns kPix whole pixels. It loads their ids once,
// coalesced, and stages each record's address in shared memory (row
// clip(max(id, 0) >> 7), lane max(id, 0) & 127: no division); then it
// writes the block's kPix x K output floats in order, so the stores
// coalesce, 16 bytes a store. Each thread walks its (pixel, channel)
// position forward by a fixed step, so the per-float path has no
// division at all; K is a template parameter for the record widths the
// rasterizer makes (24: the G-buffer record; 30 and 33: the velocity
// record without and with the shared depth planes; 47: the textured
// G-buffer record), with one generic instantiation. Indices are 32-bit;
// only the record's address (the table may exceed 2^31 floats) and the
// block's output offset are 64-bit, once a pixel and once a block. Where
// K % 4 == 0 and the table is 16-byte aligned (checked, not assumed),
// the record is read 16 bytes at a time too; otherwise 4.
#include "common.cuh"

namespace {

constexpr int kPix = 256;  // pixels a block, one thread each

// k: the record width, KT where KT > 0 (a constant), else k_rt. vec: the
// table is 16-byte aligned and k % 4 == 0.
template <int KT>
__global__ void __launch_bounds__(kPix)
lookup_kernel(const float* __restrict__ tab, const int* __restrict__ ids,
              float* __restrict__ out, int rows, int k_rt, int n_pix,
              int vec) {
  const int k = KT > 0 ? KT : k_rt;
  RE_DYNAMIC_SHARED(const float*, s_rec);
  const int p0 = blockIdx.x * kPix;
  const int np = min(kPix, n_pix - p0);
  re::block_fill(np, [&](int i) {
    const int safe = max(ids[p0 + i], 0);
    const int r = min(safe >> 7, rows - 1);
    s_rec[i] = tab + (static_cast<size_t>(r) * 128 + (safe & 127)) * k;
  });
  float* o = out + static_cast<size_t>(p0) * k;
  const int t = threadIdx.x;
  if (vec) {
    // 16-byte units: thread t takes units t, t + kPix, ... of the
    // block's np * k/4, unit j being quad j % (k/4) of pixel j / (k/4)
    const int k4 = k >> 2;
    const int n4 = np * k4;
    const int dp = kPix / k4;
    const int dq = kPix - dp * k4;
    int p = t / k4;
    int q = t - p * k4;
    for (int j = t; j < n4; j += kPix) {
      reinterpret_cast<re::F4*>(o)[j] =
          reinterpret_cast<const re::F4*>(s_rec[p])[q];
      q += dq;
      p += dp;
      if (q >= k4) {
        q -= k4;
        ++p;
      }
    }
    return;
  }
  // groups of 4 consecutive output floats, one 16-byte store each (the
  // block's span starts kPix * k floats in: 16-byte aligned); thread t
  // takes groups t, t + kPix, ...; float i is channel i % k of pixel i / k
  const int n = np * k;
  const int ng = n >> 2;
  const int dp = 4 * kPix / k;
  const int dc = 4 * kPix - dp * k;
  int p = 4 * t / k;
  int c = 4 * t - p * k;
  for (int g = t; g < ng; g += kPix) {
    re::F4 v;
    int pp = p;
    int cc = c;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v.v[e] = s_rec[pp][cc];
      if (++cc == k) {
        cc = 0;
        ++pp;
      }
    }
    reinterpret_cast<re::F4*>(o)[g] = v;
    c += dc;
    p += dp;
    if (c >= k) {
      c -= k;
      ++p;
    }
  }
  // the last n % 4 floats (a block whose np * k is not a multiple of 4):
  // float n - 1 - e is e channels before the last pixel's last one
  const int e = t;
  if (e < (n & 3)) {
    int pp = np - 1;
    int cc = k - 1 - e;
    while (cc < 0) {
      cc += k;
      --pp;
    }
    o[n - 1 - e] = s_rec[pp][cc];
  }
}

template <int KT>
cudaError_t launch(const float* tab, const int* ids, float* out, int rows,
                   int k, int n_pix, int vec, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(n_pix / kPix + (n_pix % kPix != 0));
  lookup_kernel<KT><<<grid, kPix, kPix * sizeof(const float*), st>>>(
      tab, ids, out, rows, k, n_pix, vec);
  return cudaGetLastError();
}

}  // namespace

// ---- host entry point ----
// tab (rows, 128, k) float32; ids (n_pix,) int32; out (n_pix, k) float32,
// 16-byte aligned. Indices are 32-bit: rows * 128, n_pix and kPix * k
// stay below 2^31.
extern "C" int re_lookup(const float* tab, const int* ids, float* out,
                         int rows, int k, int n_pix, void* stream) {
  if (rows < 1 || rows > (INT32_MAX >> 7) || k < 1 || k > INT32_MAX / (4 * kPix) ||
      n_pix < 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (n_pix == 0) return cudaSuccess;
  const int vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(tab) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 24: return launch<24>(tab, ids, out, rows, k, n_pix, vec, st);
    case 30: return launch<30>(tab, ids, out, rows, k, n_pix, vec, st);
    case 33: return launch<33>(tab, ids, out, rows, k, n_pix, vec, st);
    case 47: return launch<47>(tab, ids, out, rows, k, n_pix, vec, st);
    default: return launch<0>(tab, ids, out, rows, k, n_pix, vec, st);
  }
}
