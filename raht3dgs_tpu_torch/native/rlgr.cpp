// Adaptive Run-Length Golomb-Rice (RLGR) entropy coder — native backend.
//
// Implements the Malvar DCC'06 adaptive automaton with the same parameters
// as the reference coder (L=4, U0=3, D0=1, U1=2, D1=1, unary prefix capped
// at 32 with a 32-bit escape, k_RP clamped to 32*L; see
// /root/reference/python/PyRLGR/src/libs/rlgr/membuf.{h,cpp} for the
// behavioral spec) so that produced bitstreams are byte-identical.
//
// Exposed as a plain C API for ctypes (no pybind11 dependency):
//   rlgr_encode / rlgr_decode / rlgr_buffer_free.
// Unlike the reference (per-channel std::vector<int64_t> copies through
// pybind11), this API operates directly on caller-owned contiguous arrays.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kFrac = 4;        // L: fractional adaptation units
constexpr uint64_t kUpNoRun = 3;     // U0
constexpr uint64_t kDownNoRun = 1;   // D0
constexpr uint64_t kUpRun = 2;       // U1
constexpr uint64_t kDownRun = 1;     // D1
constexpr uint64_t kEscapePrefix = 32;
constexpr uint64_t kMaxKRP = 32 * kFrac;

inline uint64_t zigzag(int64_t v) {
  // branchless: 2v for v>=0, 2|v|-1 for v<0
  return (static_cast<uint64_t>(v) << 1) ^ static_cast<uint64_t>(v >> 63);
}

inline int64_t unzigzag(uint64_t u) {
  // branchless inverse: u>>1 for even, -(u>>1)-1 for odd
  return static_cast<int64_t>(u >> 1) ^ -static_cast<int64_t>(u & 1);
}

class BitSink {
 public:
  BitSink() : buf_(static_cast<uint8_t*>(std::malloc(4096))) {}
  ~BitSink() { std::free(buf_); }
  BitSink(const BitSink&) = delete;
  BitSink& operator=(const BitSink&) = delete;

  inline void put_bits(uint64_t value, unsigned nbits) {
    // MSB-first accumulation, flushed a 32-bit word at a time (bswap +
    // unaligned store into a raw buffer: no per-byte push_back, no
    // zero-init on growth).
    while (nbits > 32) {
      put_bits(value >> 32, nbits - 32);
      value &= 0xFFFFFFFFull;
      nbits = 32;
    }
    acc_ = (acc_ << nbits) | (value & ((1ull << nbits) - 1));
    count_ += nbits;
    if (count_ >= 32) {
      count_ -= 32;
      if (sz_ + 4 > cap_) grow();
      uint32_t be = __builtin_bswap32(static_cast<uint32_t>(acc_ >> count_));
      std::memcpy(buf_ + sz_, &be, 4);
      sz_ += 4;
    }
  }

  void put_unary(uint64_t ones) {
    // `ones` 1-bits followed by a 0 terminator.
    while (ones >= 32) {
      put_bits(0xFFFFFFFFull, 32);
      ones -= 32;
    }
    put_bits(((1ull << (ones + 1)) - 1) - 1, static_cast<unsigned>(ones + 1));
  }

  void finish() {
    if (count_ % 8) put_bits(0, 8 - count_ % 8);
    while (count_ >= 8) {
      count_ -= 8;
      if (sz_ + 1 > cap_) grow();
      buf_[sz_++] = static_cast<uint8_t>((acc_ >> count_) & 0xFF);
    }
  }

  size_t size() const { return sz_; }

  // Transfer ownership of the malloc'd buffer to the caller (the C API's
  // output contract) — the encode hot path never copies the stream.
  uint8_t* release() {
    uint8_t* p = buf_;
    buf_ = nullptr;
    return p;
  }

 private:
  void grow() {
    cap_ *= 2;
    buf_ = static_cast<uint8_t*>(std::realloc(buf_, cap_));
  }
  uint8_t* buf_;
  size_t sz_ = 0;
  size_t cap_ = 4096;
  uint64_t acc_ = 0;
  unsigned count_ = 0;  // invariant: < 32 between calls
};

class BitSource {
 public:
  BitSource(const uint8_t* data, size_t len) : data_(data), len_(len) {}

  inline unsigned get_bit() {
    if (count_ == 0) refill();
    if (count_ == 0) return 0;  // past end: zeros (padded stream)
    count_--;
    return static_cast<unsigned>((acc_ >> count_) & 1);
  }

  inline uint64_t get_bits(unsigned nbits) {
    if (nbits == 0) return 0;
    if (nbits > 32) {
      uint64_t hi = get_bits(32);  // high half first (matches writer order)
      nbits -= 32;
      return (hi << nbits) | get_bits(nbits);
    }
    if (count_ < nbits) refill();
    if (count_ >= nbits) {
      count_ -= nbits;
      return (acc_ >> count_) & ((1ull << nbits) - 1);
    }
    // past end: remaining bits MSB-first, then zeros
    uint64_t v = (acc_ & ((1ull << count_) - 1)) << (nbits - count_);
    count_ = 0;
    return v;
  }

  // Count consecutive 1-bits up to `cap` via count-leading-zeros on the
  // bit window (instead of bit-at-a-time); consumes the counted ones and,
  // if cap wasn't hit, the terminating 0-bit. Past-end reads see zeros.
  inline unsigned take_ones(unsigned cap) {
    unsigned q = 0;
    for (;;) {
      if (count_ == 0) {
        refill();
        if (count_ == 0) return q;  // past end: implicit terminator
      }
      uint64_t aligned = acc_ << (64 - count_);  // MSB = next bit
      unsigned ones =
          (~aligned == 0) ? 64 : static_cast<unsigned>(__builtin_clzll(~aligned));
      if (ones > count_) ones = count_;
      if (q + ones >= cap) {
        count_ -= cap - q;  // consume exactly the capping ones, no terminator
        return cap;
      }
      if (ones < count_) {
        count_ -= ones + 1;  // ones + the 0 terminator
        return q + ones;
      }
      q += ones;  // window was all ones; refill and continue
      count_ = 0;
    }
  }

 private:
  void refill() {
    while (count_ <= 56 && pos_ < len_) {
      acc_ = (acc_ << 8) | data_[pos_++];
      count_ += 8;
    }
  }
  const uint8_t* data_;
  size_t len_;
  size_t pos_ = 0;
  uint64_t acc_ = 0;
  unsigned count_ = 0;
};

// Golomb-Rice codeword with escape: unary(quotient) + k-bit remainder, or
// 32 ones + raw 32-bit value when quotient >= 32.
inline void gr_put(BitSink& sink, uint64_t u, unsigned k) {
  uint64_t q = u >> k;
  if (q < kEscapePrefix) {
    // Fused codeword: q ones, a zero, then the k-bit remainder — one
    // accumulator pass for the common case (q+1+k <= 57 always holds here:
    // q <= 31, k <= 32 gives at most 64, so split only the extreme corner).
    unsigned total = static_cast<unsigned>(q) + 1 + k;
    if (total <= 57) {
      sink.put_bits((((1ull << (q + 1)) - 2) << k) | (u & ((1ull << k) - 1)),
                    total);
    } else {
      sink.put_unary(q);
      sink.put_bits(u & ((1ull << k) - 1), k);
    }
  } else {
    sink.put_bits(0xFFFFFFFFull, 32);
    sink.put_bits(u & 0xFFFFFFFFull, 32);
  }
}

inline uint64_t gr_get(BitSource& src, unsigned k) {
  uint64_t q = src.take_ones(static_cast<unsigned>(kEscapePrefix));
  if (q >= kEscapePrefix) return src.get_bits(32);
  return (q << k) + src.get_bits(k);
}

// Shared adaptation of the Golomb-Rice parameter state after coding `u`.
inline void adapt_krp(uint64_t& k_rp, uint64_t u, unsigned k_r) {
  uint64_t q = u >> k_r;
  if (q) {
    k_rp += q - 1;
    if (k_rp > kMaxKRP) k_rp = kMaxKRP;
  } else {
    k_rp = (k_rp < 2) ? 0 : k_rp - 2;
  }
}

}  // namespace

extern "C" {

// Encode n int64 symbols. On return *out points to a malloc'd buffer of
// *out_len bytes (caller frees with rlgr_buffer_free). Returns 0 on success.
int rlgr_encode(const int64_t* seq, size_t n, int flag_signed, uint8_t** out,
                size_t* out_len) {
  BitSink sink;
  uint64_t k_p = 0;            // run-length parameter (fractional)
  uint64_t k_rp = 2 * kFrac;   // GR parameter (fractional)
  uint64_t run = 0;            // pending zero-run length
  uint64_t k = 0;              // last-iteration run exponent
  uint64_t u = 0;              // last-iteration coded value

  for (size_t i = 0; i < n; i++) {
    u = flag_signed ? zigzag(seq[i]) : static_cast<uint64_t>(seq[i]);
    k = k_p / kFrac;
    unsigned k_r = static_cast<unsigned>(k_rp / kFrac);

    if (k == 0) {
      // No-run mode: every symbol gets a GR codeword.
      gr_put(sink, u, k_r);
      adapt_krp(k_rp, u, k_r);
      if (u)
        k_p = (k_p < kDownNoRun) ? 0 : k_p - kDownNoRun;
      else
        k_p += kUpNoRun;
      run = 0;
    } else if (u == 0) {
      // Run mode, zero symbol: extend the pending run.
      if (++run == (1ull << k)) {
        sink.put_bits(1, 1);  // complete run of 2^k zeros
        k_p += kUpRun;
        run = 0;
      }
    } else {
      // Run mode, nonzero symbol terminates the partial run. The in-place
      // decrement mirrors the reference's `u--` (membuf.cpp:359), which
      // aliases the trailing-flush test below: a final mapped value of
      // exactly 1 leaves u == 0 and triggers a spurious-but-contractual
      // flush that byte-identity requires.
      u -= 1;
      sink.put_bits(0, 1);
      sink.put_bits(run, static_cast<unsigned>(k));
      gr_put(sink, u, k_r);
      adapt_krp(k_rp, u, k_r);
      k_p = (k_p < kDownRun) ? 0 : k_p - kDownRun;
      run = 0;
    }
  }
  // Flush a pending (possibly empty) partial run so the decoder can finish.
  if (k && u == 0) {
    sink.put_bits(0, 1);
    sink.put_bits(run, static_cast<unsigned>(k_p / kFrac));
  }
  sink.finish();

  *out_len = sink.size();
  *out = sink.release();
  if (!*out) return -1;
  return 0;
}

// Decode n symbols from buf into seq. Returns 0 on success.
int rlgr_decode(const uint8_t* buf, size_t len, int flag_signed, int64_t* seq,
                size_t n) {
  BitSource src(buf, len);
  uint64_t k_p = 0;
  uint64_t k_rp = 2 * kFrac;
  size_t i = 0;

  while (i < n) {
    uint64_t k = k_p / kFrac;
    unsigned k_r = static_cast<unsigned>(k_rp / kFrac);

    if (k) {
      // Run mode: 1-bits are complete runs of 2^k zeros (k adapts inline).
      uint64_t zeros = 0;
      while (src.get_bit()) {
        zeros += 1ull << k;
        k_p += kUpRun;
        k = k_p / kFrac;
      }
      zeros += src.get_bits(static_cast<unsigned>(k));
      while (zeros-- && i < n) seq[i++] = 0;
      if (i >= n) break;

      uint64_t u = gr_get(src, k_r);
      seq[i++] = flag_signed ? unzigzag(u + 1)
                             : static_cast<int64_t>(u + 1);
      adapt_krp(k_rp, u, k_r);
      k_p = (k_p < kDownRun) ? 0 : k_p - kDownRun;
    } else {
      uint64_t u = gr_get(src, k_r);
      seq[i++] = flag_signed ? unzigzag(u) : static_cast<int64_t>(u);
      adapt_krp(k_rp, u, k_r);
      if (u)
        k_p = (k_p < kDownNoRun) ? 0 : k_p - kDownNoRun;
      else
        k_p += kUpNoRun;
    }
  }
  return 0;
}

void rlgr_buffer_free(uint8_t* buf) { std::free(buf); }

// int32 entry points: same automaton, no host-side widening copies (the
// codec's quantized coefficients are int32).
int rlgr_encode32(const int32_t* seq, size_t n, int flag_signed, uint8_t** out,
                  size_t* out_len) {
  BitSink sink;
  uint64_t k_p = 0, k_rp = 2 * kFrac, run = 0, k = 0, u = 0;
  for (size_t i = 0; i < n; i++) {
    u = flag_signed ? zigzag(seq[i])
                    : static_cast<uint64_t>(static_cast<uint32_t>(seq[i]));
    k = k_p / kFrac;
    unsigned k_r = static_cast<unsigned>(k_rp / kFrac);
    if (k == 0) {
      gr_put(sink, u, k_r);
      adapt_krp(k_rp, u, k_r);
      if (u)
        k_p = (k_p < kDownNoRun) ? 0 : k_p - kDownNoRun;
      else
        k_p += kUpNoRun;
      run = 0;
    } else if (u == 0) {
      if (++run == (1ull << k)) {
        sink.put_bits(1, 1);
        k_p += kUpRun;
        run = 0;
      }
    } else {
      u -= 1;  // mirrors the reference's aliasing `u--` (see rlgr_encode)
      sink.put_bits(0, 1);
      sink.put_bits(run, static_cast<unsigned>(k));
      gr_put(sink, u, k_r);
      adapt_krp(k_rp, u, k_r);
      k_p = (k_p < kDownRun) ? 0 : k_p - kDownRun;
      run = 0;
    }
  }
  if (k && u == 0) {
    sink.put_bits(0, 1);
    sink.put_bits(run, static_cast<unsigned>(k_p / kFrac));
  }
  sink.finish();
  *out_len = sink.size();
  *out = sink.release();
  if (!*out) return -1;
  return 0;
}

int rlgr_decode32(const uint8_t* buf, size_t len, int flag_signed,
                  int32_t* seq, size_t n) {
  BitSource src(buf, len);
  uint64_t k_p = 0, k_rp = 2 * kFrac;
  size_t i = 0;
  while (i < n) {
    uint64_t k = k_p / kFrac;
    unsigned k_r = static_cast<unsigned>(k_rp / kFrac);
    if (k) {
      uint64_t zeros = 0;
      while (src.get_bit()) {
        zeros += 1ull << k;
        k_p += kUpRun;
        k = k_p / kFrac;
      }
      zeros += src.get_bits(static_cast<unsigned>(k));
      while (zeros-- && i < n) seq[i++] = 0;
      if (i >= n) break;
      uint64_t u = gr_get(src, k_r);
      seq[i++] = flag_signed
                     ? static_cast<int32_t>(unzigzag(u + 1))
                     : static_cast<int32_t>(u + 1);
      adapt_krp(k_rp, u, k_r);
      k_p = (k_p < kDownRun) ? 0 : k_p - kDownRun;
    } else {
      uint64_t u = gr_get(src, k_r);
      seq[i++] = flag_signed ? static_cast<int32_t>(unzigzag(u))
                             : static_cast<int32_t>(u);
      adapt_krp(k_rp, u, k_r);
      if (u)
        k_p = (k_p < kDownNoRun) ? 0 : k_p - kDownNoRun;
      else
        k_p += kUpNoRun;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Batched parallel entry points: run `count` independent coder jobs with an
// internal thread pool — ONE ctypes crossing for a whole frame's entropy
// stage (channels x chunks), instead of per-stream calls bouncing through
// the Python GIL. Jobs are the same automaton as the single-stream API, so
// every produced stream is byte-identical to a single-stream encode of the
// same slice (chunk independence comes from the per-chunk automaton reset
// the chunked container format already mandates).

}  // extern "C" (the pool helper below is a template — C++ linkage)

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
// out_lens[j] bytes (each freed with rlgr_buffer_free). n_threads <= 0
// selects the hardware concurrency. Returns 0 iff every job succeeded.
int rlgr_encode_batch32(const int32_t* data, const size_t* offsets,
                        const size_t* ns, size_t count, int flag_signed,
                        int n_threads, uint8_t** outs, size_t* out_lens) {
  std::atomic<int> rc{0};
  run_jobs(count, n_threads, [&](size_t j) {
    if (rlgr_encode32(data + offsets[j], ns[j], flag_signed, &outs[j],
                      &out_lens[j]) != 0)
      rc.store(-1, std::memory_order_relaxed);
  });
  return rc.load();
}

// Decode `count` jobs in parallel: job j decodes ns[j] symbols from
// buf + buf_offsets[j] (buf_lens[j] bytes) into out + out_offsets[j].
int rlgr_decode_batch32(const uint8_t* buf, const size_t* buf_offsets,
                        const size_t* buf_lens, const size_t* ns,
                        const size_t* out_offsets, size_t count,
                        int flag_signed, int n_threads, int32_t* out) {
  std::atomic<int> rc{0};
  run_jobs(count, n_threads, [&](size_t j) {
    if (rlgr_decode32(buf + buf_offsets[j], buf_lens[j], flag_signed,
                      out + out_offsets[j], ns[j]) != 0)
      rc.store(-1, std::memory_order_relaxed);
  });
  return rc.load();
}

// Single Golomb-Rice codeword helpers (reference exposes grWrite/grRead on
// its membuf; these support the same micro-benchmarks/tests).
int gr_encode_one(uint64_t value, unsigned k, uint8_t** out, size_t* out_len) {
  BitSink sink;
  gr_put(sink, value, k);
  sink.finish();
  *out_len = sink.size();
  *out = sink.release();
  if (!*out) return -1;
  return 0;
}

uint64_t gr_decode_one(const uint8_t* buf, size_t len, unsigned k) {
  BitSource src(buf, len);
  return gr_get(src, k);
}

}  // extern "C"
