// Per-column sums of squared differences of two row-major float32
// matrices, the one pass behind eval/metrics.py:gs_group_psnr.
//
// Each element's difference is taken in float32, as numpy's `a - b` takes
// it; its square is exact in float64 and is accumulated in float64. The
// rows are split into blocks of kBlockRows, independent of the thread
// count: a block sums its columns in row order, and the block partials are
// added in block order, so every pool size gives the same bits.

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <thread>
#include <vector>

namespace {

constexpr size_t kBlockRows = 4096;

void block_sums(const float* __restrict__ a, const float* __restrict__ b,
                size_t r0, size_t r1, size_t d, double* __restrict__ acc) {
  std::fill(acc, acc + d, 0.0);
  for (size_t i = r0; i < r1; ++i) {
    const float* pa = a + i * d;
    const float* pb = b + i * d;
    for (size_t c = 0; c < d; ++c) {
      const double diff = static_cast<double>(pa[c] - pb[c]);
      acc[c] += diff * diff;
    }
  }
}

}  // namespace

extern "C" {

// out[c] = sum over the n rows of (a[i, c] - b[i, c])^2, for c < d.
// n_threads <= 0 selects the hardware concurrency. Returns 0, or -1 when
// n or d is 0.
int sq_diff_col_sums_f32(const float* a, const float* b, size_t n, size_t d,
                         int n_threads, double* out) {
  if (n == 0 || d == 0) return -1;
  const size_t blocks = (n + kBlockRows - 1) / kBlockRows;
  std::vector<double> partial(blocks * d);
  std::atomic<size_t> next{0};
  // a worker sums a block in its own buffer, then stores the block's row:
  // workers share no cache line while they sum
  auto work = [&] {
    std::vector<double> acc(d);
    for (size_t k; (k = next.fetch_add(1, std::memory_order_relaxed)) < blocks;) {
      block_sums(a, b, k * kBlockRows, std::min(n, (k + 1) * kBlockRows), d, acc.data());
      std::copy(acc.begin(), acc.end(), partial.begin() + k * d);
    }
  };
  size_t hw = std::thread::hardware_concurrency();
  size_t t = n_threads > 0 ? static_cast<size_t>(n_threads) : (hw ? hw : 1);
  t = std::min(t, blocks);
  if (t <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(t);
    for (size_t w = 0; w < t; ++w) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  std::fill(out, out + d, 0.0);
  for (size_t k = 0; k < blocks; ++k)
    for (size_t c = 0; c < d; ++c) out[c] += partial[k * d + c];
  return 0;
}

}  // extern "C"
