// Native environment-map preprocessing: luminance CDF inversion + half
// decode.
//
// C++ replacement for the reference's Web Worker
// (`src/ssgi/utils/EquirectHdrInfoUniform.js:5-264`): the
// host-side precompute that builds the marginal/conditional inverse-CDF
// lookup tables for environment importance sampling, plus the half-float
// -> float conversion used when loading 16-bit HDR images. Rows of the
// conditional table are independent, so they parallelize across a small
// thread pool (the worker's concurrency, without the message passing).
//
// Built on demand by realism_effects_tpu_torch/native/__init__.py with
// g++ into build/native/; exposed over ctypes. A numpy fallback with
// identical semantics lives in core/envmap.py.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline double luminance(float r, float g, float b) {
  return 0.2125 * r + 0.7154 * g + 0.0721 * b;
}

// first index i in [lo, lo+n) with data[i] >= target, relative to lo
inline int lower_bound_ge(const double* data, int n, double target) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) / 2;
    if (data[mid] < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

}  // namespace

extern "C" {

// rgb: interleaved float32 (height*width*3). Outputs:
//   marginal_out:    float32[height]  — inverse CDF over rows
//   conditional_out: float32[height*width] — inverse CDF per row
// Returns the total luminance sum.
double build_equirect_cdf(const float* rgb, int width, int height,
                          int num_threads, float* marginal_out,
                          float* conditional_out) {
  std::vector<double> row_sums(height, 0.0);
  std::vector<double> cdf_cond(static_cast<size_t>(height) * width);

  if (num_threads <= 0) {
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 4;
  }
  num_threads = std::min(num_threads, height);

  // pass 1: per-row cumulative luminance (parallel over rows)
  {
    std::atomic<int> next_row{0};
    auto worker = [&]() {
      for (;;) {
        int y = next_row.fetch_add(1);
        if (y >= height) return;
        const float* row = rgb + static_cast<size_t>(y) * width * 3;
        double* crow = cdf_cond.data() + static_cast<size_t>(y) * width;
        double acc = 0.0;
        for (int x = 0; x < width; ++x) {
          acc += luminance(row[3 * x], row[3 * x + 1], row[3 * x + 2]);
          crow[x] = acc;
        }
        row_sums[y] = acc;
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < num_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }

  double total = 0.0;
  for (int y = 0; y < height; ++y) total += row_sums[y];

  // marginal CDF over rows + inversion (`EquirectHdrInfoUniform.js:226-233`)
  std::vector<double> cdf_marg(height);
  {
    double acc = 0.0;
    for (int y = 0; y < height; ++y) {
      acc += row_sums[y];
      cdf_marg[y] = total > 0.0 ? acc / total : acc;
    }
    for (int y = 0; y < height; ++y) {
      double dist = (y + 1.0) / height;
      int row = lower_bound_ge(cdf_marg.data(), height, dist);
      if (row > height - 1) row = height - 1;
      marginal_out[y] = static_cast<float>((row + 0.5) / height);
    }
  }

  // conditional inversion per row (`EquirectHdrInfoUniform.js:235-243`),
  // parallel over rows
  {
    std::atomic<int> next_row{0};
    auto worker = [&]() {
      for (;;) {
        int y = next_row.fetch_add(1);
        if (y >= height) return;
        double* crow = cdf_cond.data() + static_cast<size_t>(y) * width;
        double rs = row_sums[y] != 0.0 ? row_sums[y] : 1.0;
        for (int x = 0; x < width; ++x) crow[x] /= rs;
        float* out = conditional_out + static_cast<size_t>(y) * width;
        for (int x = 0; x < width; ++x) {
          double dist = (x + 1.0) / width;
          int col = lower_bound_ge(crow, width, dist);
          if (col > width - 1) col = width - 1;
          out[x] = static_cast<float>((col + 0.5) / width);
        }
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < num_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }

  return total;
}

// IEEE half -> float, the worker's `fromHalfFloat` table lookup
// (`EquirectHdrInfoUniform.js:16-141`) as straight bit math.
void half_to_float(const uint16_t* src, float* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint16_t h = src[i];
    uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1Fu;
    uint32_t mant = h & 0x3FFu;
    uint32_t bits;
    if (exp == 0) {
      if (mant == 0) {
        bits = sign;  // +-0
      } else {        // subnormal
        int e = -1;
        uint32_t m = mant;
        do {
          ++e;
          m <<= 1;
        } while ((m & 0x400u) == 0);
        bits = sign | ((127 - 15 - e) << 23) | ((m & 0x3FFu) << 13);
      }
    } else if (exp == 31) {
      bits = sign | 0x7F800000u | (mant << 13);  // inf / nan
    } else {
      bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float f;
    std::memcpy(&f, &bits, sizeof(f));
    dst[i] = f;
  }
}

}  // extern "C"
