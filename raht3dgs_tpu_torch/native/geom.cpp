// Geometry entropy coder: adaptive binary range coding of octree occupancy
// bytes — native backend.
//
// This is a beyond-reference capability (the reference transmits attributes
// only and assumes decoder-side geometry; see encode_ply.py). The stream
// format is frozen here and mirrored bit-for-bit by the Python fallback
// (raht3dgs_tpu/codec/_geom_py.py); tests assert byte-identity between the
// two backends.
//
// Coder: carry-less LZMA-style binary range coder (32-bit range, 64-bit low
// with cache/cache_size byte emission), 12-bit adaptive probabilities with
// shift-5 update, initialized to 1/2.
//
// Context model (profile 0): each occupancy byte is decomposed LSB-first
// into 8 binary decisions (bit c == "child c occupied"). The context of a
// bit is
//   (level bank, binary-tree node)
// where the level bank is min(level, 7) — shallow octree levels are
// near-dense, deep levels sparse, and sharing them would drag both — and
// the tree node is the standard ctx = ctx*2 + bit walk (ctx in [1, 255]):
// together the 255 adaptive bins model the full joint byte distribution
// within a bank.
// One structural bit is free: an occupancy byte is never zero, so when the
// first 7 children are absent the last bit is forced 1 and not coded.
//
// MEASURED DEAD END (richer contexts): conditioning additionally on the
// parent byte, the node's octant, or the 3 face-adjacent sibling bits
// (sib3) cuts the STATIC conditional entropy 7-24% on synthetic surface
// shells, but loses ADAPTIVELY at codec stream sizes (85k-360k bytes):
// bank-only 8.48/4.87 bits/voxel vs sib3*child 8.68/5.19 (J=10/J=8,
// exact -log2(p) simulation of this coder) — splitting 255 tree contexts
// across 64x more banks costs more in relearning than the context
// explains. Dual-rate adaptation (shift 3 for the first 16 updates)
// recovers only ~0.01 bpv. Revisit with real scans (vs noisy synthetic
// shells) under a new profile byte if richer contexts ever pay.
//
// The byte stream is self-framing given the octree depth: level 0 is one
// byte and each level's node count is the popcount sum of the previous
// level (see ops/octree.py). Both entry points walk levels that way, so the
// API needs no side table.
//
// Exposed as a plain C API for ctypes (no pybind11 dependency):
//   geom_encode / geom_decode / geom_buffer_free.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#include "range_coder.h"

namespace {

using raht_rc::ByteSink;
using raht_rc::RangeDecoder;
using raht_rc::RangeEncoder;
using raht_rc::kProbInit;

constexpr unsigned kLevelBanks = 8;
constexpr unsigned kTreeCtx = 256;  // index 1..255 used
constexpr unsigned kNumCtx = kLevelBanks * kTreeCtx;

inline unsigned level_bank(size_t level) {
  return level < kLevelBanks ? static_cast<unsigned>(level)
                             : kLevelBanks - 1;
}

inline uint16_t* bank_of(uint16_t* probs, size_t level) {
  return probs + level_bank(level) * kTreeCtx;
}

inline void encode_byte(RangeEncoder& enc, uint16_t* bank, uint8_t b) {
  unsigned ctx = 1;
  for (unsigned i = 0; i < 8; ++i) {
    const unsigned bit = (b >> i) & 1u;
    if (i == 7 && ctx == 1) break;  // forced 1: byte can't be zero
    enc.encode_bit(&bank[ctx], bit);
    ctx = (ctx << 1) | bit;
  }
}

inline uint8_t decode_byte(RangeDecoder& dec, uint16_t* bank) {
  unsigned ctx = 1;
  unsigned b = 0;
  for (unsigned i = 0; i < 8; ++i) {
    unsigned bit;
    if (i == 7 && ctx == 1) {
      bit = 1;  // forced: occupancy bytes are never zero
    } else {
      bit = dec.decode_bit(&bank[ctx]);
    }
    b |= bit << i;
    ctx = (ctx << 1) | bit;
  }
  return static_cast<uint8_t>(b);
}

}  // namespace

extern "C" {

// Encode n occupancy bytes (levels 0..depth-1, self-framing) into a
// malloc'd buffer returned via *out / *out_len (caller frees with
// geom_buffer_free). Returns 0 on success, -1 on allocation failure, -2 if
// the level walk is inconsistent with n (zero byte, or size mismatch).
int geom_encode(const uint8_t* occ, size_t n, size_t depth, uint8_t** out,
                size_t* out_len) {
  if (n == 0 || depth == 0) return -2;
  ByteSink sink;
  if (!sink.buf) return -1;
  RangeEncoder enc(&sink);
  std::vector<uint16_t> probs(kNumCtx, kProbInit);

  // level-driven walk: each level's byte count is the popcount sum of the
  // previous level's bytes (the self-framing rule of ops/octree.py)
  size_t pos = 0, n_nodes = 1;
  for (size_t level = 0; level < depth; ++level) {
    if (pos + n_nodes > n) return -2;
    uint16_t* bank = bank_of(probs.data(), level);
    size_t next_nodes = 0;
    for (size_t j = 0; j < n_nodes; ++j) {
      const uint8_t b = occ[pos + j];
      if (b == 0) return -2;
      next_nodes += static_cast<size_t>(__builtin_popcount(b));
      encode_byte(enc, bank, b);
    }
    pos += n_nodes;
    n_nodes = next_nodes;
  }
  if (pos != n) return -2;  // leaves (level == depth) carry no bytes
  enc.flush();
  if (sink.failed) return -1;
  *out_len = sink.len;
  *out = sink.release();
  if (!*out) return -1;
  return 0;
}

// Decode into caller-owned out[0..out_cap); writes the decoded byte count
// to *out_n. Returns 0 on success, -2 if the decoded walk would exceed
// out_cap (corrupt stream or wrong capacity).
int geom_decode(const uint8_t* buf, size_t buf_len, size_t depth,
                uint8_t* out, size_t out_cap, size_t* out_n) {
  if (depth == 0 || out_cap == 0) return -2;
  RangeDecoder dec(buf, buf_len);
  std::vector<uint16_t> probs(kNumCtx, kProbInit);

  size_t pos = 0, n_nodes = 1;
  for (size_t level = 0; level < depth; ++level) {
    if (pos + n_nodes > out_cap) return -2;
    uint16_t* bank = bank_of(probs.data(), level);
    size_t next_nodes = 0;
    for (size_t j = 0; j < n_nodes; ++j) {
      const uint8_t b = decode_byte(dec, bank);
      out[pos + j] = b;
      next_nodes += static_cast<size_t>(__builtin_popcount(b));
    }
    pos += n_nodes;
    n_nodes = next_nodes;
  }
  *out_n = pos;
  return 0;
}

void geom_buffer_free(uint8_t* buf) { std::free(buf); }

// Fused intra decode: entropy-decode the occupancy walk AND rebuild the
// leaf Morton codes in one pass (the numpy two-stage path pays a second,
// larger bit-matrix expansion — measured 61 ms vs 36 ms entropy at 568k
// voxels). Emits the zlib-compatible crc32 of the decoded occupancy bytes
// so the caller can verify the section checksum without materializing
// them. out holds the sorted leaf codes; every level's node count is
// guarded against out_cap (each internal node has at least one descendant
// leaf, so any well-formed level fits). Returns 0, or -2 on overflow.

namespace {

struct Crc32 {
  uint32_t table[256];
  Crc32() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1u) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
  }
};
const Crc32 kCrc;

inline uint32_t crc32_update(uint32_t crc, uint8_t b) {
  return kCrc.table[(crc ^ b) & 0xFFu] ^ (crc >> 8);
}

}  // namespace

// Fused intra encode: build the octree levels from sorted unique leaf
// codes and entropy-code the occupancy walk in one native call,
// returning the section payload and the zlib-compatible crc32 of the
// occupancy bytes. Mirrors ops/octree.py's serialization exactly (same
// breadth-first order). Returns 0; -1 on allocation failure; -2 if codes
// are not strictly increasing (caller validates range/sortedness too).
int geom_encode_codes(const uint64_t* codes, size_t n, size_t depth,
                      uint8_t** out, size_t* out_len, uint32_t* crc_out) {
  if (n == 0 || depth == 0) return -2;
  // bottom-up: per level, the sorted node codes
  std::vector<std::vector<uint64_t>> levels(depth + 1);
  levels[depth].assign(codes, codes + n);
  for (size_t i = 1; i < n; ++i) {
    if (codes[i] <= codes[i - 1]) return -2;
  }
  for (size_t l = depth; l > 0; --l) {
    const std::vector<uint64_t>& cur = levels[l];
    std::vector<uint64_t>& par = levels[l - 1];
    par.reserve(cur.size() / 2 + 1);
    uint64_t prev = ~0ull;
    for (uint64_t c : cur) {
      const uint64_t p = c >> 3;
      if (p != prev) {
        par.push_back(p);
        prev = p;
      }
    }
  }
  ByteSink sink;
  if (!sink.buf) return -1;
  RangeEncoder enc(&sink);
  std::vector<uint16_t> probs(kNumCtx, kProbInit);
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t l = 0; l < depth; ++l) {
    uint16_t* bank = bank_of(probs.data(), l);
    const std::vector<uint64_t>& nodes = levels[l];
    const std::vector<uint64_t>& kids = levels[l + 1];
    size_t k = 0;
    for (uint64_t node : nodes) {
      uint8_t b = 0;
      while (k < kids.size() && (kids[k] >> 3) == node) {
        b |= static_cast<uint8_t>(1u << (kids[k] & 7u));
        ++k;
      }
      crc = crc32_update(crc, b);
      encode_byte(enc, bank, b);
    }
  }
  enc.flush();
  if (sink.failed) return -1;
  *out_len = sink.len;
  *out = sink.release();
  if (!*out) return -1;
  *crc_out = crc ^ 0xFFFFFFFFu;
  return 0;
}

int geom_decode_codes(const uint8_t* buf, size_t buf_len, size_t depth,
                      uint64_t* out, size_t out_cap, size_t* out_n,
                      uint32_t* crc_out) {
  if (depth == 0 || out_cap == 0) return -2;
  RangeDecoder dec(buf, buf_len);
  std::vector<uint16_t> probs(kNumCtx, kProbInit);
  std::vector<uint64_t> cur(1, 0), next;
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t level = 0; level < depth; ++level) {
    uint16_t* bank = bank_of(probs.data(), level);
    next.clear();
    next.reserve(cur.size() * 2);
    for (uint64_t code : cur) {
      const uint8_t b = decode_byte(dec, bank);
      crc = crc32_update(crc, b);
      for (unsigned c = 0; c < 8; ++c) {
        if ((b >> c) & 1u) next.push_back((code << 3) | c);
      }
    }
    if (next.size() > out_cap) return -2;
    cur.swap(next);
  }
  std::memcpy(out, cur.data(), cur.size() * sizeof(uint64_t));
  *out_n = cur.size();
  *crc_out = crc ^ 0xFFFFFFFFu;
  return 0;
}

// LOD (prefix) decode of an intra (profile 0) section: walk only octree
// levels 0..max_level-1 and return the node codes AT level max_level —
// coarse positions without decoding the deep levels that dominate the
// stream (breadth-first order makes a level cut a stream prefix; the
// range decoder simply stops early). No CRC: the checksum covers the full
// occupancy walk and cannot be verified on a partial decode — the Python
// front-end cross-checks the node count bound instead.
int geom_decode_codes_lod(const uint8_t* buf, size_t buf_len, size_t depth,
                          size_t max_level, uint64_t* out, size_t out_cap,
                          size_t* out_n) {
  if (depth == 0 || out_cap == 0) return -2;
  if (max_level == 0 || max_level > depth) return -2;
  RangeDecoder dec(buf, buf_len);
  std::vector<uint16_t> probs(kNumCtx, kProbInit);
  std::vector<uint64_t> cur(1, 0), next;
  for (size_t level = 0; level < max_level; ++level) {
    uint16_t* bank = bank_of(probs.data(), level);
    next.clear();
    next.reserve(cur.size() * 2);
    for (uint64_t code : cur) {
      const uint8_t b = decode_byte(dec, bank);
      for (unsigned c = 0; c < 8; ++c) {
        if ((b >> c) & 1u) next.push_back((code << 3) | c);
      }
    }
    if (next.size() > out_cap) return -2;
    cur.swap(next);
  }
  std::memcpy(out, cur.data(), cur.size() * sizeof(uint64_t));
  *out_n = cur.size();
  return 0;
}

// ---------------------------------------------------------------------------
// Temporal coder (geometry profile 1): stateful level-by-level API.
//
// P-frame octrees are coded with contexts conditioned on the PREVIOUS
// frame's decoded octree: for each current node matched (same code, same
// level) to a previous-frame node, bit i's context gains that node's
// previous occupancy bit i. Measured on the synthetic deforming sequence
// (exact adaptive simulation): 2.818 -> 2.450 bits/voxel at J=8 and
// 4.800 -> 4.322 at J=9 vs the intra profile (-13% / -10%); the full
// previous BYTE as context measured no better (2.469 / 4.303) while
// multiplying banks 64x, so the per-bit flag is the keeper.
//
// Contexts: (level bank, tflag, tree node) with tflag in {0: unmatched,
// 2: prev bit 0, 3: prev bit 1} (1 reserved) -> 4x the intra bank count.
//
// The node matching (searchsorted between the frames' per-level sorted
// codes) is vectorized numpy in codec/geometry.py; the Python<->native
// ping-pong is one call per octree level (<= 21). The caller must keep
// the stream buffer alive for the lifetime of a decoder handle.

namespace {

constexpr unsigned kTFlagCtx = 4;
constexpr unsigned kNumCtxT = kLevelBanks * kTFlagCtx * kTreeCtx;

inline uint16_t* bank_of_t(uint16_t* probs, size_t level, unsigned tflag) {
  return probs + (level_bank(level) * kTFlagCtx + tflag) * kTreeCtx;
}

struct GeomEnc {
  ByteSink sink;
  RangeEncoder enc;
  std::vector<uint16_t> probs;
  explicit GeomEnc(size_t n_ctx) : enc(&sink), probs(n_ctx, kProbInit) {}
};

struct GeomDec {
  RangeDecoder dec;
  std::vector<uint16_t> probs;
  GeomDec(const uint8_t* buf, size_t len, size_t n_ctx)
      : dec(buf, len), probs(n_ctx, kProbInit) {}
};

inline void* new_enc(size_t n_ctx) {
  GeomEnc* e = new (std::nothrow) GeomEnc(n_ctx);
  if (e && !e->sink.buf) {  // carry the intra path's malloc-failure guard
    delete e;
    return nullptr;
  }
  return e;
}

}  // namespace

void* geom_enc_new() { return new_enc(kNumCtxT); }

// Encode one level's occupancy bytes. matched[j] != 0 means node j exists
// in the previous frame with occupancy prevbyte[j]. Returns 0, or -2 on a
// zero occupancy byte.
int geom_enc_level(void* h, const uint8_t* occ, const uint8_t* matched,
                   const uint8_t* prevbyte, size_t n, size_t level) {
  GeomEnc* e = static_cast<GeomEnc*>(h);
  for (size_t j = 0; j < n; ++j) {
    const uint8_t b = occ[j];
    if (b == 0) return -2;
    const bool m = matched[j] != 0;
    const uint8_t pb = prevbyte[j];
    unsigned ctx = 1;
    for (unsigned i = 0; i < 8; ++i) {
      const unsigned bit = (b >> i) & 1u;
      if (i == 7 && ctx == 1) break;  // forced 1: byte can't be zero
      const unsigned tflag = m ? (2u + ((pb >> i) & 1u)) : 0u;
      uint16_t* bank = bank_of_t(e->probs.data(), level, tflag);
      e->enc.encode_bit(&bank[ctx], bit);
      ctx = (ctx << 1) | bit;
    }
  }
  return 0;
}

// Flush and hand the stream to the caller (free with geom_buffer_free).
// Call once; the handle still needs geom_enc_free afterwards.
int geom_enc_finish(void* h, uint8_t** out, size_t* out_len) {
  GeomEnc* e = static_cast<GeomEnc*>(h);
  e->enc.flush();
  if (e->sink.failed) return -1;
  *out_len = e->sink.len;
  *out = e->sink.release();
  return *out ? 0 : -1;
}

void geom_enc_free(void* h) { delete static_cast<GeomEnc*>(h); }

void* geom_dec_new(const uint8_t* buf, size_t len) {
  return new (std::nothrow) GeomDec(buf, len, kNumCtxT);
}

// Decode one level's n occupancy bytes into out (never zero bytes).
int geom_dec_level(void* h, const uint8_t* matched, const uint8_t* prevbyte,
                   size_t n, size_t level, uint8_t* out) {
  GeomDec* d = static_cast<GeomDec*>(h);
  for (size_t j = 0; j < n; ++j) {
    const bool m = matched[j] != 0;
    const uint8_t pb = prevbyte[j];
    unsigned ctx = 1;
    unsigned b = 0;
    for (unsigned i = 0; i < 8; ++i) {
      unsigned bit;
      if (i == 7 && ctx == 1) {
        bit = 1;  // forced: occupancy bytes are never zero
      } else {
        const unsigned tflag = m ? (2u + ((pb >> i) & 1u)) : 0u;
        uint16_t* bank = bank_of_t(d->probs.data(), level, tflag);
        bit = d->dec.decode_bit(&bank[ctx]);
      }
      b |= bit << i;
      ctx = (ctx << 1) | bit;
    }
    out[j] = static_cast<uint8_t>(b);
  }
  return 0;
}

void geom_dec_free(void* h) { delete static_cast<GeomDec*>(h); }

}  // extern "C"

// ---------------------------------------------------------------------------
// ext3-context profiles (geometry profiles 3-5).
//
// Re-judged on scan-like occupancy statistics (articulated body scans,
// eval/synth.synthetic_body_scan; scripts/exp_geom_contexts.py): unlike
// the parent-byte/octant/sib3 candidates measured above as adaptive dead
// ends, conditioning each occupancy bit on the SAME-LEVEL face-neighbor
// occupancy of the child's three outward sides ("ext3") wins decisively —
// intra 1.99 -> 1.54 b/v on body J=10 (-23%), -4% even on the noisy
// shells, -0.1% worst case (blob); temporal 1.87 -> 1.50 b/v (-20%).
// The feature is exactly decodable: a level's full node set (hence its
// cell map) is known before any of that level's bytes is read.
//
// Contexts: intra (level bank, ext3, tree) = 8*8*256; temporal
// (level bank, tflag, ext3, tree) = 8*4*8*256. n6 byte layout (must match
// ops/octree.py:level_neighbors6): bit 0 x-, 1 x+, 2 y-, 3 y+, 4 z-, 5 z+
// with Morton digit = z + 2y + 4x.

namespace {

constexpr unsigned kExtCtx = 8;
constexpr unsigned kNumCtx3 = kLevelBanks * kExtCtx * kTreeCtx;
constexpr unsigned kNumCtxT4 = kLevelBanks * kTFlagCtx * kExtCtx * kTreeCtx;

inline uint64_t spread3(uint64_t x) {
  x &= 0x00000000001FFFFFull;
  x = (x | (x << 32)) & 0x001F00000000FFFFull;
  x = (x | (x << 16)) & 0x001F0000FF0000FFull;
  x = (x | (x << 8)) & 0x100F00F00F00F00Full;
  x = (x | (x << 4)) & 0x10C30C30C30C30C3ull;
  x = (x | (x << 2)) & 0x1249249249249249ull;
  return x;
}

inline uint64_t compact3(uint64_t x) {
  x &= 0x1249249249249249ull;
  x = (x | (x >> 2)) & 0x10C30C30C30C30C3ull;
  x = (x | (x >> 4)) & 0x100F00F00F00F00Full;
  x = (x | (x >> 8)) & 0x001F0000FF0000FFull;
  x = (x | (x >> 16)) & 0x001F00000000FFFFull;
  x = (x | (x >> 32)) & 0x00000000001FFFFFull;
  return x;
}

// Open-addressing set of one level's codes (linear probing, 2x load
// headroom): the n6 computation issues 6 membership probes per node, and
// O(1) probes beat a binary search's ~20 cache-missy compares ~8x at
// codec sizes.
struct LevelHash {
  std::vector<uint64_t> slots;  // code+1; 0 = empty (codes can be 0)
  uint64_t mask = 0;
  static inline uint64_t h(uint64_t k) {
    return (k * 0x9E3779B97F4A7C15ull) >> 17;
  }
  void build(const uint64_t* codes, size_t n) {
    size_t cap = 16;
    while (cap < 2 * n) cap <<= 1;
    slots.assign(cap, 0);
    mask = cap - 1;
    for (size_t i = 0; i < n; ++i) {
      uint64_t p = h(codes[i]) & mask;
      while (slots[p]) p = (p + 1) & mask;
      slots[p] = codes[i] + 1;
    }
  }
  inline bool contains(uint64_t k) const {
    uint64_t p = h(k) & mask;
    while (slots[p]) {
      if (slots[p] == k + 1) return true;
      p = (p + 1) & mask;
    }
    return false;
  }
};

// Face-neighbor occupancy byte of every node in a sorted level-`level`
// code array. Mirror of ops/octree.py:level_neighbors6 (pinned by the
// backend byte-identity tests — the VALUES are frozen format, the
// implementation is free).
//
// Per axis, exactly ONE of the two face neighbors shares the node's
// parent cell (the one reached by flipping the coordinate's low bit):
// sorted codes make siblings a contiguous run, so those 3 probes are
// answered from the run's 8-bit octant mask instead of the hash — only
// the 3 parent-crossing probes pay a (cache-missing) table lookup.
void compute_n6(const uint64_t* codes, size_t n, size_t level,
                uint8_t* out, LevelHash* scratch) {
  if (level == 0) {
    std::memset(out, 0, n);
    return;
  }
  scratch->build(codes, n);
  const uint64_t lim = (1ull << level) - 1;
  size_t j = 0;
  while (j < n) {
    const uint64_t parent = codes[j] >> 3;
    size_t j1 = j;
    uint8_t occ = 0;  // the parent's occupancy byte, rebuilt from the run
    while (j1 < n && (codes[j1] >> 3) == parent) {
      occ |= static_cast<uint8_t>(1u << (codes[j1] & 7u));
      ++j1;
    }
    for (size_t k = j; k < j1; ++k) {
      const uint64_t c = codes[k];
      const unsigned oct = static_cast<unsigned>(c & 7u);
      uint8_t b = 0;
      unsigned bit = 0;
      for (int a = 0; a < 3; ++a) {
        const unsigned sh = static_cast<unsigned>(2 - a);
        const unsigned low = (oct >> sh) & 1u;
        // in-parent side: flip the octant bit, test the run mask
        const unsigned in_bit = bit + (low ? 0u : 1u);  // low=1: d=-1
        if ((occ >> (oct ^ (1u << sh))) & 1u) b |= 1u << in_bit;
        // parent-crossing side: hash probe (grid-edge guarded)
        const uint64_t coord = compact3(c >> sh);
        const unsigned out_bit = bit + (low ? 1u : 0u);
        const bool valid = low ? coord < lim : coord > 0;
        if (valid) {
          const uint64_t ncoord = low ? coord + 1 : coord - 1;
          const uint64_t ncode =
              (c & ~(spread3(lim) << sh)) | (spread3(ncoord) << sh);
          if (scratch->contains(ncode)) b |= 1u << out_bit;
        }
        bit += 2;
      }
      out[k] = b;
    }
    j = j1;
  }
}

// ext3 pattern of child bit i given the node's n6 byte: the outward
// neighbor on each axis is the -side bit when the octant bit is 0.
inline unsigned ext3_of(uint8_t n6, unsigned i) {
  const unsigned ex = (n6 >> ((i >> 2) & 1u)) & 1u;
  const unsigned ey = (n6 >> (2u + ((i >> 1) & 1u))) & 1u;
  const unsigned ez = (n6 >> (4u + (i & 1u))) & 1u;
  return (ex << 2) | (ey << 1) | ez;
}

inline uint16_t* bank_of3(uint16_t* probs, size_t level, unsigned ext3) {
  return probs + (level_bank(level) * kExtCtx + ext3) * kTreeCtx;
}

inline uint16_t* bank_of_t4(uint16_t* probs, size_t level, unsigned tflag,
                            unsigned ext3) {
  return probs +
         ((level_bank(level) * kTFlagCtx + tflag) * kExtCtx + ext3) *
             kTreeCtx;
}

inline void encode_byte3(RangeEncoder& enc, uint16_t* probs, size_t level,
                         uint8_t n6, uint8_t b) {
  unsigned ctx = 1;
  for (unsigned i = 0; i < 8; ++i) {
    const unsigned bit = (b >> i) & 1u;
    if (i == 7 && ctx == 1) break;  // forced 1: byte can't be zero
    uint16_t* bank = bank_of3(probs, level, ext3_of(n6, i));
    enc.encode_bit(&bank[ctx], bit);
    ctx = (ctx << 1) | bit;
  }
}

inline uint8_t decode_byte3(RangeDecoder& dec, uint16_t* probs,
                            size_t level, uint8_t n6) {
  unsigned ctx = 1;
  unsigned b = 0;
  for (unsigned i = 0; i < 8; ++i) {
    unsigned bit;
    if (i == 7 && ctx == 1) {
      bit = 1;  // forced: occupancy bytes are never zero
    } else {
      uint16_t* bank = bank_of3(probs, level, ext3_of(n6, i));
      bit = dec.decode_bit(&bank[ctx]);
    }
    b |= bit << i;
    ctx = (ctx << 1) | bit;
  }
  return static_cast<uint8_t>(b);
}

}  // namespace

extern "C" {

// Fused intra encode with ext3 contexts (geometry profile 3). Same
// contract as geom_encode_codes.
int geom_encode_codes3(const uint64_t* codes, size_t n, size_t depth,
                       uint8_t** out, size_t* out_len, uint32_t* crc_out) {
  if (n == 0 || depth == 0) return -2;
  std::vector<std::vector<uint64_t>> levels(depth + 1);
  levels[depth].assign(codes, codes + n);
  for (size_t i = 1; i < n; ++i) {
    if (codes[i] <= codes[i - 1]) return -2;
  }
  for (size_t l = depth; l > 0; --l) {
    const std::vector<uint64_t>& cur = levels[l];
    std::vector<uint64_t>& par = levels[l - 1];
    par.reserve(cur.size() / 2 + 1);
    uint64_t prev = ~0ull;
    for (uint64_t c : cur) {
      const uint64_t p = c >> 3;
      if (p != prev) {
        par.push_back(p);
        prev = p;
      }
    }
  }
  ByteSink sink;
  if (!sink.buf) return -1;
  RangeEncoder enc(&sink);
  std::vector<uint16_t> probs(kNumCtx3, kProbInit);
  std::vector<uint8_t> n6;
  LevelHash nbr;
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t l = 0; l < depth; ++l) {
    const std::vector<uint64_t>& nodes = levels[l];
    const std::vector<uint64_t>& kids = levels[l + 1];
    n6.resize(nodes.size());
    compute_n6(nodes.data(), nodes.size(), l, n6.data(), &nbr);
    size_t k = 0;
    for (size_t j = 0; j < nodes.size(); ++j) {
      uint8_t b = 0;
      while (k < kids.size() && (kids[k] >> 3) == nodes[j]) {
        b |= static_cast<uint8_t>(1u << (kids[k] & 7u));
        ++k;
      }
      crc = crc32_update(crc, b);
      encode_byte3(enc, probs.data(), l, n6[j], b);
    }
  }
  enc.flush();
  if (sink.failed) return -1;
  *out_len = sink.len;
  *out = sink.release();
  if (!*out) return -1;
  *crc_out = crc ^ 0xFFFFFFFFu;
  return 0;
}

// Fused intra decode with ext3 contexts (geometry profile 3). Same
// contract as geom_decode_codes.
int geom_decode_codes3(const uint8_t* buf, size_t buf_len, size_t depth,
                       uint64_t* out, size_t out_cap, size_t* out_n,
                       uint32_t* crc_out) {
  if (depth == 0 || out_cap == 0) return -2;
  RangeDecoder dec(buf, buf_len);
  std::vector<uint16_t> probs(kNumCtx3, kProbInit);
  std::vector<uint64_t> cur(1, 0), next;
  std::vector<uint8_t> n6;
  LevelHash nbr;
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t level = 0; level < depth; ++level) {
    n6.resize(cur.size());
    compute_n6(cur.data(), cur.size(), level, n6.data(), &nbr);
    next.clear();
    next.reserve(cur.size() * 2);
    for (size_t j = 0; j < cur.size(); ++j) {
      const uint8_t b = decode_byte3(dec, probs.data(), level, n6[j]);
      crc = crc32_update(crc, b);
      for (unsigned c = 0; c < 8; ++c) {
        if ((b >> c) & 1u) next.push_back((cur[j] << 3) | c);
      }
    }
    if (next.size() > out_cap) return -2;
    cur.swap(next);
  }
  std::memcpy(out, cur.data(), cur.size() * sizeof(uint64_t));
  *out_n = cur.size();
  *crc_out = crc ^ 0xFFFFFFFFu;
  return 0;
}

// LOD decode of an ext3 intra (profile 3) section — the profile-3
// counterpart of geom_decode_codes_lod (same early-stop contract).
int geom_decode_codes3_lod(const uint8_t* buf, size_t buf_len, size_t depth,
                           size_t max_level, uint64_t* out, size_t out_cap,
                           size_t* out_n) {
  if (depth == 0 || out_cap == 0) return -2;
  if (max_level == 0 || max_level > depth) return -2;
  RangeDecoder dec(buf, buf_len);
  std::vector<uint16_t> probs(kNumCtx3, kProbInit);
  std::vector<uint64_t> cur(1, 0), next;
  std::vector<uint8_t> n6;
  LevelHash nbr;
  for (size_t level = 0; level < max_level; ++level) {
    n6.resize(cur.size());
    compute_n6(cur.data(), cur.size(), level, n6.data(), &nbr);
    next.clear();
    next.reserve(cur.size() * 2);
    for (size_t j = 0; j < cur.size(); ++j) {
      const uint8_t b = decode_byte3(dec, probs.data(), level, n6[j]);
      for (unsigned c = 0; c < 8; ++c) {
        if ((b >> c) & 1u) next.push_back((cur[j] << 3) | c);
      }
    }
    if (next.size() > out_cap) return -2;
    cur.swap(next);
  }
  std::memcpy(out, cur.data(), cur.size() * sizeof(uint64_t));
  *out_n = cur.size();
  return 0;
}

// Temporal coder with ext3 contexts (geometry profiles 4-5): the caller
// passes each node's n6 byte (computed by ops/octree.py:level_neighbors6
// on the CURRENT frame's level codes — available to the decoder before
// the level's bytes are read). Shares geom_enc_finish / geom_enc_free /
// geom_dec_free with the profile-1 handles.
void* geom_enc_new4() { return new_enc(kNumCtxT4); }

int geom_enc_level4(void* h, const uint8_t* occ, const uint8_t* matched,
                    const uint8_t* prevbyte, const uint8_t* n6, size_t n,
                    size_t level) {
  GeomEnc* e = static_cast<GeomEnc*>(h);
  for (size_t j = 0; j < n; ++j) {
    const uint8_t b = occ[j];
    if (b == 0) return -2;
    const bool m = matched[j] != 0;
    const uint8_t pb = prevbyte[j];
    unsigned ctx = 1;
    for (unsigned i = 0; i < 8; ++i) {
      const unsigned bit = (b >> i) & 1u;
      if (i == 7 && ctx == 1) break;  // forced 1: byte can't be zero
      const unsigned tflag = m ? (2u + ((pb >> i) & 1u)) : 0u;
      uint16_t* bank =
          bank_of_t4(e->probs.data(), level, tflag, ext3_of(n6[j], i));
      e->enc.encode_bit(&bank[ctx], bit);
      ctx = (ctx << 1) | bit;
    }
  }
  return 0;
}

void* geom_dec_new4(const uint8_t* buf, size_t len) {
  return new (std::nothrow) GeomDec(buf, len, kNumCtxT4);
}

int geom_dec_level4(void* h, const uint8_t* matched,
                    const uint8_t* prevbyte, const uint8_t* n6, size_t n,
                    size_t level, uint8_t* out) {
  GeomDec* d = static_cast<GeomDec*>(h);
  for (size_t j = 0; j < n; ++j) {
    const bool m = matched[j] != 0;
    const uint8_t pb = prevbyte[j];
    unsigned ctx = 1;
    unsigned b = 0;
    for (unsigned i = 0; i < 8; ++i) {
      unsigned bit;
      if (i == 7 && ctx == 1) {
        bit = 1;  // forced: occupancy bytes are never zero
      } else {
        const unsigned tflag = m ? (2u + ((pb >> i) & 1u)) : 0u;
        uint16_t* bank =
            bank_of_t4(d->probs.data(), level, tflag, ext3_of(n6[j], i));
        bit = d->dec.decode_bit(&bank[ctx]);
      }
      b |= bit << i;
      ctx = (ctx << 1) | bit;
    }
    out[j] = static_cast<uint8_t>(b);
  }
  return 0;
}

}  // extern "C"
