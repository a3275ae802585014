// Shared binary range coder: carry-less LZMA-style (32-bit range, 64-bit
// low with cache/cache_size byte emission), 12-bit adaptive probabilities
// with shift-k update, initialized to 1/2.
//
// ONE automaton serves every adaptive-binary stream format in the repo:
// the geometry coder (geom.cpp, frozen profiles 0-5) and the attribute
// RAC coder (rac.cpp). The byte-level behavior here is FROZEN stream
// format — tests pin byte-identity against the pure-Python mirrors
// (codec/_geom_py.py, codec/_rac_py.py); never change it without a new
// leading profile byte in every consumer.
//
// The direct-bit (bypass) path costs exactly 1 bit/bit and is used for
// signs and Rice remainders in rac.cpp (geom.cpp does not use it).

#ifndef RAHT3DGS_NATIVE_RANGE_CODER_H_
#define RAHT3DGS_NATIVE_RANGE_CODER_H_

#include <cstdint>
#include <cstdlib>

namespace raht_rc {

constexpr unsigned kProbBits = 12;
constexpr uint16_t kProbInit = 1u << (kProbBits - 1);  // 2048: p(bit==0)
constexpr unsigned kAdaptShift = 5;
constexpr uint32_t kTopValue = 1u << 24;

struct ByteSink {
  uint8_t* buf;
  size_t len = 0, cap;
  explicit ByteSink(size_t c0 = 4096)
      : buf(static_cast<uint8_t*>(std::malloc(c0))), cap(c0) {}
  ~ByteSink() { std::free(buf); }
  ByteSink(const ByteSink&) = delete;
  ByteSink& operator=(const ByteSink&) = delete;
  bool failed = false;
  inline void put(uint8_t b) {
    if (len == cap) {
      uint8_t* nb = static_cast<uint8_t*>(std::realloc(buf, cap * 2));
      if (!nb) {  // keep the old buffer; surface as the -1 alloc error
        failed = true;
        return;
      }
      buf = nb;
      cap *= 2;
    }
    buf[len++] = b;
  }
  uint8_t* release() {
    uint8_t* p = buf;
    buf = nullptr;
    return p;
  }
};

class RangeEncoder {
 public:
  explicit RangeEncoder(ByteSink* out) : out_(out) {}

  inline void encode_bit(uint16_t* prob, unsigned bit) {
    const uint32_t bound = (range_ >> kProbBits) * *prob;
    if (bit == 0) {
      range_ = bound;
      *prob += ((1u << kProbBits) - *prob) >> kAdaptShift;
    } else {
      low_ += bound;
      range_ -= bound;
      *prob -= *prob >> kAdaptShift;
    }
    while (range_ < kTopValue) {
      shift_low();
      range_ <<= 8;
    }
  }

  // bypass path: nbits raw bits, MSB first, exactly 1 bit each
  inline void encode_direct(uint32_t value, unsigned nbits) {
    for (unsigned i = nbits; i-- > 0;) {
      range_ >>= 1;
      if ((value >> i) & 1u) low_ += range_;
      while (range_ < kTopValue) {
        shift_low();
        range_ <<= 8;
      }
    }
  }

  void flush() {
    for (int i = 0; i < 5; ++i) shift_low();
  }

 private:
  inline void shift_low() {
    if (static_cast<uint32_t>(low_) < 0xFF000000u || (low_ >> 32) != 0) {
      uint8_t carry = static_cast<uint8_t>(low_ >> 32);
      uint8_t temp = cache_;
      do {
        out_->put(static_cast<uint8_t>(temp + carry));
        temp = 0xFF;
      } while (--cache_size_ != 0);
      cache_ = static_cast<uint8_t>(low_ >> 24);
    }
    ++cache_size_;
    low_ = (low_ & 0x00FFFFFFull) << 8;
  }

  ByteSink* out_;
  uint64_t low_ = 0;
  uint32_t range_ = 0xFFFFFFFFu;
  uint8_t cache_ = 0;
  uint64_t cache_size_ = 1;
};

class RangeDecoder {
 public:
  RangeDecoder(const uint8_t* buf, size_t len) : buf_(buf), len_(len) {
    // the first emitted byte is always the initial cache (0); skip it and
    // preload 4 code bytes, zero-padding past the end (a well-formed
    // stream never reads past it for real decisions)
    next();  // skip
    for (int i = 0; i < 4; ++i) code_ = (code_ << 8) | next();
  }

  inline unsigned decode_bit(uint16_t* prob) {
    const uint32_t bound = (range_ >> kProbBits) * *prob;
    unsigned bit;
    if (code_ < bound) {
      bit = 0;
      range_ = bound;
      *prob += ((1u << kProbBits) - *prob) >> kAdaptShift;
    } else {
      bit = 1;
      code_ -= bound;
      range_ -= bound;
      *prob -= *prob >> kAdaptShift;
    }
    while (range_ < kTopValue) {
      code_ = (code_ << 8) | next();
      range_ <<= 8;
    }
    return bit;
  }

  inline uint32_t decode_direct(unsigned nbits) {
    uint32_t v = 0;
    for (unsigned i = 0; i < nbits; ++i) {
      range_ >>= 1;
      unsigned bit = code_ >= range_;
      if (bit) code_ -= range_;
      v = (v << 1) | bit;
      while (range_ < kTopValue) {
        code_ = (code_ << 8) | next();
        range_ <<= 8;
      }
    }
    return v;
  }

 private:
  inline uint8_t next() { return pos_ < len_ ? buf_[pos_++] : 0; }

  const uint8_t* buf_;
  size_t len_, pos_ = 0;
  uint32_t code_ = 0, range_ = 0xFFFFFFFFu;
};

}  // namespace raht_rc

#endif  // RAHT3DGS_NATIVE_RANGE_CODER_H_
