// The host pack of a quantized int32 symbol matrix before its upload, the
// two passes behind models/pipeline.py:pack_quantized_upload.
//
// The flat array is split into blocks of kBlock entries, independent of
// the thread count. Pass 1 counts each block once: its nonzeros, its
// entries with |v| >= 2^7 and with |v| >= 2^15, and its largest |v| (in
// int64, so INT32_MIN is exact). The caller picks the tier from the totals
// and gives pass 2 each block's exclusive-prefix offset into the tier's
// index list, so the lists come out in ascending flat order and every pool
// size writes the same bytes. Pass 2 writes only the chosen tier: the
// matrix narrowed with the wrap-around of a C cast (numpy's `astype`) and
// its overflow entries, or the nonzeros alone.

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr size_t kBlock = size_t{1} << 16;

// |x| >= 2^(bits - 1) for an int32 x, without overflow: x + (2^(bits-1) - 1)
// in uint32 lies in [0, 2^bits - 2] exactly when |x| < 2^(bits - 1)
template <int Bits>
inline bool overflows(int32_t x) {
  constexpr uint32_t half = (uint32_t{1} << (Bits - 1)) - 1;
  return static_cast<uint32_t>(x) + half > 2 * half;
}

// Runs f(k) for every block k < blocks on min(threads, blocks) threads;
// n_threads <= 0 selects the hardware concurrency.
template <class F>
void for_blocks(size_t blocks, int n_threads, F&& f) {
  std::atomic<size_t> next{0};
  auto work = [&] {
    for (size_t k; (k = next.fetch_add(1, std::memory_order_relaxed)) < blocks;) f(k);
  };
  size_t hw = std::thread::hardware_concurrency();
  size_t t = n_threads > 0 ? static_cast<size_t>(n_threads) : (hw ? hw : 1);
  t = std::min(t, blocks);
  if (t <= 1) {
    work();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (size_t w = 0; w < t; ++w) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

template <class T>
void narrow(const int32_t* v, size_t n, const int64_t* offsets, int n_threads, T* out,
            int32_t* idx, int32_t* val) {
  for_blocks((n + kBlock - 1) / kBlock, n_threads, [&](size_t k) {
    const size_t r0 = k * kBlock, r1 = std::min(n, r0 + kBlock);
    for (size_t i = r0; i < r1; ++i) out[i] = static_cast<T>(v[i]);
    if (idx == nullptr) return;
    int64_t p = offsets[k];
    for (size_t i = r0; i < r1; ++i) {
      if (overflows<8 * sizeof(T)>(v[i])) {
        idx[p] = static_cast<int32_t>(i);
        val[p] = v[i];
        ++p;
      }
    }
  });
}

template <class T>
void nonzeros(const int32_t* v, size_t n, const int64_t* offsets, int n_threads, int32_t* idx,
              T* val) {
  // nonzeros fall at random, so a branch on each entry mispredicts often:
  // every entry is written to a small local buffer and the cursor moves on
  // past the nonzeros alone, then the buffer's nonzeros are copied out
  constexpr size_t kChunk = 4096;
  for_blocks((n + kBlock - 1) / kBlock, n_threads, [&](size_t k) {
    const size_t r0 = k * kBlock, r1 = std::min(n, r0 + kBlock);
    int32_t li[kChunk];
    T lv[kChunk];
    int64_t p = offsets[k];
    for (size_t c0 = r0; c0 < r1; c0 += kChunk) {
      const size_t c1 = std::min(r1, c0 + kChunk);
      size_t m = 0;
      for (size_t i = c0; i < c1; ++i) {
        const int32_t x = v[i];
        li[m] = static_cast<int32_t>(i);
        lv[m] = static_cast<T>(x);
        m += x != 0;
      }
      std::copy(li, li + m, idx + p);
      std::copy(lv, lv + m, val + p);
      p += static_cast<int64_t>(m);
    }
  });
}

}  // namespace

extern "C" {

// Entries a block: the caller sizes counts and offsets by it.
size_t upload_pack_block() { return kBlock; }

// Pass 1. counts[4k .. 4k + 3] = block k's nonzeros, entries with
// |v| >= 2^7, entries with |v| >= 2^15, and largest |v|. Returns 0, or -1
// when n is 0.
int upload_pack_count(const int32_t* v, size_t n, int n_threads, int64_t* counts) {
  if (n == 0) return -1;
  for_blocks((n + kBlock - 1) / kBlock, n_threads, [&](size_t k) {
    const size_t r0 = k * kBlock, r1 = std::min(n, r0 + kBlock);
    // a block's counts fit 32 bits, which keeps the loop vectorised
    uint32_t nnz = 0, over8 = 0, over16 = 0;
    int32_t hi = 0, lo = 0;
    for (size_t i = r0; i < r1; ++i) {
      const int32_t x = v[i];
      nnz += x != 0;
      over8 += overflows<8>(x);
      over16 += overflows<16>(x);
      hi = std::max(hi, x);
      lo = std::min(lo, x);
    }
    int64_t* c = counts + 4 * k;
    c[0] = nnz;
    c[1] = over8;
    c[2] = over16;
    c[3] = std::max(static_cast<int64_t>(hi), -static_cast<int64_t>(lo));
  });
  return 0;
}

// Pass 2, a dense tier: out[i] = v[i] cast to `bits` (8 or 16) bits. With
// idx set, block k also writes its entries with |v| >= 2^(bits - 1), from
// offsets[k] on: their flat indices to idx and their exact values to val.
// Returns 0, or -1 for n 0 or other bits.
int upload_pack_narrow(const int32_t* v, size_t n, int bits, const int64_t* offsets,
                       int n_threads, void* out, int32_t* idx, int32_t* val) {
  if (n == 0) return -1;
  if (bits == 8)
    narrow(v, n, offsets, n_threads, static_cast<int8_t*>(out), idx, val);
  else if (bits == 16)
    narrow(v, n, offsets, n_threads, static_cast<int16_t*>(out), idx, val);
  else
    return -1;
  return 0;
}

// Pass 2, the sparse tier: block k writes its nonzeros from offsets[k] on,
// their flat indices to idx and their values, cast to val_bytes (1, 2 or
// 4) bytes, to val. Returns 0, or -1 for n 0 or other val_bytes.
int upload_pack_sparse(const int32_t* v, size_t n, int val_bytes, const int64_t* offsets,
                       int n_threads, int32_t* idx, void* val) {
  if (n == 0) return -1;
  if (val_bytes == 1)
    nonzeros(v, n, offsets, n_threads, idx, static_cast<int8_t*>(val));
  else if (val_bytes == 2)
    nonzeros(v, n, offsets, n_threads, idx, static_cast<int16_t*>(val));
  else if (val_bytes == 4)
    nonzeros(v, n, offsets, n_threads, idx, static_cast<int32_t*>(val));
  else
    return -1;
  return 0;
}

}  // extern "C"
