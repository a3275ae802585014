// Attribute entropy coder: context-adaptive binary range coding of
// quantized RAHT coefficient streams ("RAC") — native backend.
//
// This is a beyond-reference rate profile. The reference's attribute
// entropy stage is per-channel RLGR (PyRLGR/src/libs/rlgr/rlgr.cpp —
// adaptive run-length + Golomb-Rice, NO context modeling, one global
// state). Replacing it with an adaptive binary range coder measured
// -7..-13% rate across the reference's full step grid on both smooth and
// scan-like content at IDENTICAL reconstructions (the quantizer is
// untouched, so PSNR is bitwise unchanged and the rate win is pure;
// scripts/exp_attr_contexts.py, docs/rd_attr_entropy.md). Context
// enrichment beyond per-decision adaptivity (previous-magnitude,
// position-bucket) measured ~0 on top and is NOT in the format; the
// cross-channel variant is future work behind a new profile byte.
//
// Coder: the shared automaton (range_coder.h — same 12-bit shift-5
// recurrence as geom.cpp, byte-level behavior frozen and mirrored
// bit-for-bit by codec/_rac_py.py; tests pin byte identity).
//
// Stream layout (per channel / per chunk):
//   u8 profile (0)  |  u8 k[8] packed 4-bit (Rice parameter per position
//   bucket, encoder-chosen by exhaustive two-pass search)  |  range-coded
//   payload.
//
// Per symbol q (stream order):
//   sig = [q != 0]     adaptive ctx 0
//   sign               1 direct bit (1 = negative)
//   gt1 = [|q| > 1]    adaptive ctx 1
//   gt2 = [|q| > 2]    adaptive ctx 2
//   rem = |q| - 3      Rice(k[bucket(i)]): unary quotient as direct bits
//                      (q ones + 0 terminator), k direct LSBs; quotients
//                      >= 20 escape to 20 ones + 32 raw bits of rem.
//
// bucket(i) = min(7, floor(log2(i+1)) * 8 / max(ceil(log2(n)), 1)) — a
// decoder-available position feature (log-spaced over the stream) used
// ONLY to segment the Rice parameter table; n is the full channel symbol
// count, so prefix decodes (progressive/LOD) see identical buckets.
//
// Exposed as a plain C API for ctypes (no pybind11 dependency):
//   rac_encode / rac_decode / rac_buffer_free.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "range_coder.h"

namespace {

using raht_rc::ByteSink;
using raht_rc::RangeDecoder;
using raht_rc::RangeEncoder;
using raht_rc::kProbInit;

constexpr unsigned kNumCtx = 3;       // sig, gt1, gt2 (profile 0)
constexpr unsigned kNumCtxCond = 6;   // {sig,gt1,gt2} x ysig (profile 1)
constexpr unsigned kBuckets = 8;
constexpr unsigned kMaxK = 15;        // 4-bit field
constexpr unsigned kEscapeQ = 20;     // quotient cap before 32-bit escape
constexpr uint8_t kProfile = 0;
// profile 1: cross-channel conditioning — every adaptive decision kind
// doubles its contexts on cond[i] (conventionally: is the CO-LOCATED
// decoded channel-0 coefficient nonzero). Same header/Rice layout.
constexpr uint8_t kProfileCond = 1;

inline unsigned bit_len_u64(uint64_t v) {
  return v ? 64u - static_cast<unsigned>(__builtin_clzll(v)) : 0u;
}

// min(7, floor(log2(i+1)) * 8 / top), top = max(ceil(log2(n)), 1)
inline unsigned bucket_of(uint64_t i, unsigned top) {
  const unsigned lg = bit_len_u64(i + 1) - 1;
  const unsigned b = lg * 8u / top;
  return b < kBuckets - 1 ? b : kBuckets - 1;
}

inline unsigned top_of(uint64_t n) {
  // ceil(log2(n)) for n >= 2 is bit_len(n - 1); clamp to >= 1
  const unsigned t = n > 1 ? bit_len_u64(n - 1) : 0;
  return t ? t : 1u;
}

inline uint64_t rice_cost(uint32_t rem, unsigned k) {
  const uint32_t q = rem >> k;
  return q >= kEscapeQ ? kEscapeQ + 32 : q + 1 + k;
}

// Shared coding core: cond == nullptr selects profile 0 (3 contexts);
// else profile 1, each decision kind's context doubled on cond[i] != 0.
int encode_impl(const int32_t* q, size_t n, const uint8_t* cond,
                uint8_t** out, size_t* out_len) {
  if (!q || !out || !out_len) return -2;
  const unsigned top = top_of(n);

  // pass 1: best Rice k per bucket (exhaustive over the 4-bit range)
  std::vector<std::vector<uint32_t>> rems(kBuckets);
  for (size_t i = 0; i < n; ++i) {
    const uint32_t mag =
        q[i] < 0 ? static_cast<uint32_t>(-static_cast<int64_t>(q[i]))
                 : static_cast<uint32_t>(q[i]);
    if (mag > 2) rems[bucket_of(i, top)].push_back(mag - 3);
  }
  uint8_t ks[kBuckets];
  for (unsigned b = 0; b < kBuckets; ++b) {
    uint64_t best = UINT64_MAX;
    unsigned bk = 0;
    for (unsigned k = 0; k <= kMaxK; ++k) {
      uint64_t c = 0;
      for (uint32_t r : rems[b]) c += rice_cost(r, k);
      if (c < best) {
        best = c;
        bk = k;
      }
    }
    ks[b] = static_cast<uint8_t>(bk);
  }

  // pass 2: header + range-coded payload
  ByteSink sink;
  if (!sink.buf) return -1;
  sink.put(cond ? kProfileCond : kProfile);
  for (unsigned b = 0; b < kBuckets; b += 2)
    sink.put(static_cast<uint8_t>(ks[b] | (ks[b + 1] << 4)));
  RangeEncoder enc(&sink);
  uint16_t probs[kNumCtxCond];
  for (unsigned c = 0; c < kNumCtxCond; ++c) probs[c] = kProbInit;
  for (size_t i = 0; i < n; ++i) {
    const unsigned y = cond ? (cond[i] ? 1u : 0u) : 0u;
    const unsigned stride = cond ? 2u : 1u;
    const int32_t v = q[i];
    const uint32_t mag =
        v < 0 ? static_cast<uint32_t>(-static_cast<int64_t>(v))
              : static_cast<uint32_t>(v);
    enc.encode_bit(&probs[0 * stride + y], mag != 0);
    if (mag == 0) continue;
    enc.encode_direct(v < 0, 1);
    enc.encode_bit(&probs[1 * stride + y], mag > 1);
    if (mag <= 1) continue;
    enc.encode_bit(&probs[2 * stride + y], mag > 2);
    if (mag <= 2) continue;
    const uint32_t rem = mag - 3;
    const unsigned k = ks[bucket_of(i, top)];
    const uint32_t quot = rem >> k;
    if (quot >= kEscapeQ) {
      for (unsigned j = 0; j < kEscapeQ; ++j) enc.encode_direct(1, 1);
      enc.encode_direct(rem, 32);
    } else {
      for (uint32_t j = 0; j < quot; ++j) enc.encode_direct(1, 1);
      enc.encode_direct(0, 1);
      if (k) enc.encode_direct(rem & ((1u << k) - 1), k);
    }
  }
  enc.flush();
  if (sink.failed) return -1;
  *out_len = sink.len;
  *out = sink.release();
  return 0;
}

int decode_impl(const uint8_t* buf, size_t len, size_t n_decode,
                size_t n_total, const uint8_t* cond, int32_t* out) {
  if (!buf || !out || n_decode > n_total) return -2;
  const uint8_t want = cond ? kProfileCond : kProfile;
  if (len < 1 + kBuckets / 2 || buf[0] != want) return -2;
  uint8_t ks[kBuckets];
  for (unsigned b = 0; b < kBuckets; b += 2) {
    ks[b] = buf[1 + b / 2] & 0x0F;
    ks[b + 1] = buf[1 + b / 2] >> 4;
  }
  const unsigned top = top_of(n_total);
  RangeDecoder dec(buf + 1 + kBuckets / 2, len - 1 - kBuckets / 2);
  uint16_t probs[kNumCtxCond];
  for (unsigned c = 0; c < kNumCtxCond; ++c) probs[c] = kProbInit;
  for (size_t i = 0; i < n_decode; ++i) {
    const unsigned y = cond ? (cond[i] ? 1u : 0u) : 0u;
    const unsigned stride = cond ? 2u : 1u;
    if (!dec.decode_bit(&probs[0 * stride + y])) {
      out[i] = 0;
      continue;
    }
    const unsigned neg = dec.decode_direct(1);
    uint32_t mag = 1;
    if (dec.decode_bit(&probs[1 * stride + y])) {
      mag = 2;
      if (dec.decode_bit(&probs[2 * stride + y])) {
        const unsigned k = ks[bucket_of(i, top)];
        uint32_t quot = 0;
        while (quot < kEscapeQ && dec.decode_direct(1)) ++quot;
        uint32_t rem;
        if (quot >= kEscapeQ) {
          rem = dec.decode_direct(32);
        } else {
          rem = (quot << k) | (k ? dec.decode_direct(k) : 0);
        }
        mag = rem + 3;
      }
    }
    out[i] = neg ? -static_cast<int64_t>(mag) : static_cast<int64_t>(mag);
  }
  return 0;
}

}  // namespace

extern "C" {

// Encode n int32 symbols into a malloc'd buffer returned via *out /
// *out_len (caller frees with rac_buffer_free). Returns 0 on success,
// -1 on allocation failure, -2 on bad arguments.
int rac_encode(const int32_t* q, size_t n, uint8_t** out,
               size_t* out_len) {
  return encode_impl(q, n, nullptr, out, out_len);
}

// Profile-1 encode: every adaptive decision conditions on cond[i] != 0
// (the co-located decoded channel-0 significance by convention).
int rac_encode_cond(const int32_t* q, const uint8_t* cond, size_t n,
                    uint8_t** out, size_t* out_len) {
  if (!cond) return -2;
  return encode_impl(q, n, cond, out, out_len);
}

// Decode the first n_decode symbols of a stream that encoded n_total
// symbols (prefix decodes use n_decode < n_total; the bucket table
// depends only on n_total). Returns 0 on success, -2 on bad arguments or
// an unknown profile byte.
int rac_decode(const uint8_t* buf, size_t len, size_t n_decode,
               size_t n_total, int32_t* out) {
  return decode_impl(buf, len, n_decode, n_total, nullptr, out);
}

// Profile-1 decode; cond must hold the first n_decode conditioning bits.
int rac_decode_cond(const uint8_t* buf, size_t len, size_t n_decode,
                    size_t n_total, const uint8_t* cond, int32_t* out) {
  if (!cond) return -2;
  return decode_impl(buf, len, n_decode, n_total, cond, out);
}

void rac_buffer_free(uint8_t* p) { std::free(p); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched parallel entry points (same pattern as rlgr.cpp): run `count`
// independent coder jobs on an internal thread pool — ONE ctypes crossing
// for a whole frame's entropy stage (channels x chunks). Every produced
// stream is byte-identical to a single-stream call on the same slice.

#include <atomic>
#include <thread>

namespace {

template <typename Fn>
void run_jobs(size_t count, int n_threads, Fn&& fn) {
  size_t hw = std::thread::hardware_concurrency();
  size_t t = n_threads > 0 ? static_cast<size_t>(n_threads) : (hw ? hw : 1);
  if (t > count) t = count;
  if (t <= 1) {
    for (size_t i = 0; i < count; i++) fn(i);
    return;
  }
  std::atomic<size_t> next{0};
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (size_t w = 0; w < t; w++) {
    pool.emplace_back([&] {
      for (;;) {
        size_t i = next.fetch_add(1, std::memory_order_relaxed);
        if (i >= count) return;
        fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Encode `count` jobs in parallel: job j codes ns[j] int32 symbols starting
// at data + offsets[j]. On return outs[j] is a malloc'd stream of
// out_lens[j] bytes (each freed with rac_buffer_free). n_threads <= 0
// selects the hardware concurrency. Returns 0 iff every job succeeded.
int rac_encode_batch(const int32_t* data, const size_t* offsets,
                     const size_t* ns, size_t count, int n_threads,
                     uint8_t** outs, size_t* out_lens) {
  std::atomic<int> rc{0};
  run_jobs(count, n_threads, [&](size_t j) {
    if (rac_encode(data + offsets[j], ns[j], &outs[j], &out_lens[j]) != 0)
      rc.store(-1, std::memory_order_relaxed);
  });
  return rc.load();
}

// Decode `count` jobs in parallel: job j decodes the first ns[j] of
// n_totals[j] symbols from buf + buf_offsets[j] (buf_lens[j] bytes) into
// out + out_offsets[j].
int rac_decode_batch(const uint8_t* buf, const size_t* buf_offsets,
                     const size_t* buf_lens, const size_t* ns,
                     const size_t* n_totals, const size_t* out_offsets,
                     size_t count, int n_threads, int32_t* out) {
  std::atomic<int> rc{0};
  run_jobs(count, n_threads, [&](size_t j) {
    if (rac_decode(buf + buf_offsets[j], buf_lens[j], ns[j], n_totals[j],
                   out + out_offsets[j]) != 0)
      rc.store(-1, std::memory_order_relaxed);
  });
  return rc.load();
}

}  // extern "C"
