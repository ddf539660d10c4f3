// Per-face record fetch: for each pixel's winning face id, the K floats
// of that face's packed record.
//
// Replaces ops/pallas/table.py::_lookup_kernel (vmem_table_lookup),
// which computes tab[clip(iy), clip(ix)] over (rows, 128, <= 8) chunks of
// the record with iy = max(id, 0) // 128 and ix = max(id, 0) % 128; the
// chunks concatenate to the whole record, so one launch serves all of
// them. The TPU kernel resolved the fetch as a dense select over every
// table row (a gather is priced per index there) and was gated to
// tables of <= 64 rows; on the H100 a thread per output float reads it
// directly (the table is at most a few MB and stays in L2), for any
// table size: neighbouring threads write neighbouring floats of the
// (pixel, channel) output, so the stores coalesce. Bound by bytes: 4 B of
// id in and 4 K B of record out a pixel. A copy: it equals advanced
// indexing bit for bit.
#include "common.cuh"

namespace {

__global__ void lookup_kernel(const float* __restrict__ tab,
                              const int* __restrict__ ids,
                              float* __restrict__ out, int rows, int k,
                              long long n_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const long long p = i / k;
  const int c = static_cast<int>(i - p * k);
  const int safe = max(ids[p], 0);
  const int r = re::clampi(safe / 128, 0, rows - 1);
  const int l = re::clampi(safe % 128, 0, 127);
  out[i] = tab[(static_cast<size_t>(r) * 128 + l) * k + c];
}

}  // namespace

// ---- host entry point ----
// tab (rows, 128, k) float32; ids (n_pix,) int32; out (n_pix, k) float32.
extern "C" int re_lookup(const float* tab, const int* ids, float* out,
                         int rows, int k, int n_pix, void* stream) {
  if (rows < 1 || k < 1 || n_pix < 0) return cudaErrorInvalidValue;
  const long long n_out = static_cast<long long>(n_pix) * k;
  if (n_out == 0) return cudaSuccess;
  const dim3 block(256);
  const dim3 grid(static_cast<unsigned>((n_out + 255) / 256));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lookup_kernel<<<grid, block, 0, st>>>(tab, ids, out, rows, k, n_out);
  return cudaGetLastError();
}
