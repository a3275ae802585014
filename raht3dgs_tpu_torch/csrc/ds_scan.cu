// Double-single (hi, lo) inclusive prefix sums of float32 columns, for Hopper.
//
// Replaces the TPU kernels of raht3dgs_tpu/ops/pallas_scan.py: _scan_kernel
// (entry ds_cumsum_pallas, the (N, K) row layout) and _scan_kernel_t (entry
// ds_cumsum_pallas_t, the transposed (K, N) layout). Both layouts are one
// kernel here: element (row, col) of the input lives at x[row * rs + col * cs],
// so the row entry passes (K, 1) and the transposed entry (1, N); hi and lo
// come out in the input's layout, one after the other. With `pack` (row
// layout only) the kernel writes instead the codec's (N + 1, 2K) prefix
// pack: a zero row, then rows [hi | lo].
//
// Numerics are the TPU kernel's error-free two-sum and ds combine
// (pallas_scan.py:_two_sum/_ds_add), ~48 mantissa bits. Every add and
// subtract is an explicit round-to-nearest intrinsic, so nvcc can neither
// contract nor reorder them; the library is built without fast math. The
// association depends on the row count alone (never on K, the layout or
// the strides): the tile size, the rows per thread and the order in which
// tile totals combine are constants, nothing is atomic and no block waits
// on a timing-dependent set of predecessors. So one column scanned alone or
// inside a wider pack gives the same bits, every run gives the same bits,
// and integer-valued lanes whose partial sums stay below 2^24 are exact.
//
// Bound on the card: bytes. The function reads 4NK bytes and writes 8NK;
// at the codec's fused pack (2^19, 4) that is 24 MiB, ~7.5 us at 3.35 TB/s.
// Design, two launches for up to 2048 tiles (4M rows):
//   1. ds_tile_total: each block reduces its 2048-row tile to per-column
//      (hi, lo) totals;
//   2. ds_tile_scan: each block first combines the totals of the tiles
//      before it (a fixed block-wide reduction over at most 2048 totals,
//      read from L2), then scans its own tile with that carry in front.
// Beyond 2048 tiles the tile totals are scanned by the same procedure
// (recursively) between the two passes. A block stages its tile in shared
// memory with coalesced 16-byte loads (neighbouring threads on neighbouring
// addresses; the row layout's tile is one contiguous run, the transposed
// layout's K runs), one pad word per 32 floats keeping each thread's 8-row
// run off its neighbours' banks. Each thread then reads its 8 rows, a
// __shfl_up_sync warp scan on hi and lo, and warp 0's scan of the 8 warp
// totals give it its exclusive prefix, and the results go back through the
// same shared buffer (hi, then lo) to coalesced stores. The second read of
// the input comes from L2 (8 MiB at the pack, far below the 50 MB L2).
// What it leaves: at the pack's 256 tiles the grid is one wave of two
// blocks per SM, so the scan pass's compensated adds (9 float adds each)
// and its stores run one after the other rather than overlapped; the input
// is read twice (once from device memory, once from L2); the pass boundary
// costs a launch (a single pass would need a look-back whose
// timing-dependent order this association rules out, or a cooperative
// grid barrier). The pack's [hi | lo] rows are staged whole, half a tile
// at a time, and stored as one contiguous run.
//
// Wider rows (the 3DGS transform's (N, 57) pack, the Gaussian merge's
// (N, 60) segment sums) take the wide path: the same two passes on a grid
// of tiles by column blocks of 8, each block reading its column slice with
// the stride of the whole row and writing its own columns of the output or
// pack. A whole 57-column tile would need 481 KB of shared memory, over
// the 227 KB a Hopper block may have; a column block stages 67.6 KB. At
// (487 180, 57) the bound is 333 MB of traffic, ~0.1 ms at 3.35 TB/s. What
// the wide path leaves: element loads and stores (a 228-byte row is not
// 16-byte aligned), one block per SM, and each column block re-reading the
// 32-byte sectors its neighbours share.
//
// The batched entry (kBatch) replaces _scan_kernel under jax.vmap, as the
// JAX package's batched codec (parallel/sharding.py) runs it: a pallas_call
// under vmap gains a leading grid axis over the frames. It runs B frames of
// one shape in one launch per pass: the frame is blockIdx.z, and each block first moves its pointers to
// its frame (input n * K floats apart, output one pack or one hi/lo pair
// apart, scratch one scratch_need apart). Nothing crosses a frame, and a
// frame's blocks do exactly the single entry's adds, so frame b's output is
// the single entry's on x[b], bit for bit. The single entry's kernels are
// the kBatch = false instances, which compile without the offsets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // rows per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCarryTiles = kTile;     // tile totals one block combines
constexpr unsigned kFull = 0xffffffffu;

enum Carry { kCarryNone = 0, kCarryTotals = 1, kCarryScanned = 2 };

// Frame strides of the batched entry, in floats: the input (in_hi, in_lo),
// the scratch (tile totals and carries) and the output. The single entry
// passes zeros, which its kBatch = false kernels never read.
struct Frames {
  long long in, tot, out;
};

// p moved to frame blockIdx.z (a null pointer stays null).
template <bool kBatch, class T>
__device__ __forceinline__ T* frame_ptr(T* p, long long stride) {
  if constexpr (kBatch) {
    return p == nullptr ? p : p + blockIdx.z * stride;
  } else {
    return p;
  }
}

// (hi, lo) <- (hi, lo) + (hi2, lo2), compensated. Commutative bitwise:
// the two-sum error term is exact whatever the operand order.
__device__ __forceinline__ void ds_add(float& hi, float& lo, float hi2,
                                       float lo2) {
  const float s = __fadd_rn(hi, hi2);
  const float bv = __fsub_rn(s, hi);
  const float err =
      __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bv)), __fsub_rn(hi2, bv));
  const float e = __fadd_rn(err, __fadd_rn(lo, lo2));
  const float h = __fadd_rn(s, e);
  lo = __fsub_rn(e, __fsub_rn(h, s));
  hi = h;
}

// Shared-memory word of the q-th staged float: one pad word per 32.
__device__ __forceinline__ int pad(int q) { return q + (q >> 5); }

// Floats of the staged tile for K columns, pad words included.
__host__ __device__ constexpr int stage_floats(int k) {
  return k * kTile + k * kTile / 32;
}

// Staged position q of element (r, c) of a tile: row-major when the matrix
// is row-contiguous (cs == 1), column-major otherwise, so the staged order
// follows the contiguous runs in device memory. For K == 1 both are q = r.
template <int K>
__device__ __forceinline__ int staged(bool row_major, int r, int c) {
  return row_major ? r * K + c : c * kTile + r;
}

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Brings rows [row0, row0 + R) of x into the staged tile s: staged slot u
// holds positions 4u..4u+3, one 16-byte load where the four are valid and
// aligned, element loads otherwise. Positions past the tile's end hold 0.
template <int K>
__device__ __forceinline__ void stage_in(const float* __restrict__ x,
                                         bool row_major, long long cs,
                                         long long row0, int R, float* s) {
  constexpr int kSlots = K * kTile / 4 / kThreads;
  float4 v[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int q = 4 * (threadIdx.x + j * kThreads);
    const float* g;
    int valid;
    if (row_major) {  // the tile is one run of R * K floats
      g = x + row0 * K + q;
      valid = R * K - q;
    } else {          // column q / kTile, rows q % kTile ..
      const int c = q / kTile, r = q % kTile;
      g = x + c * cs + row0 + r;
      valid = R - r;
    }
    if (valid >= 4 && aligned16(g)) {
      v[j] = __ldg(reinterpret_cast<const float4*>(g));
    } else {
      v[j].x = valid > 0 ? __ldg(g) : 0.f;
      v[j].y = valid > 1 ? __ldg(g + 1) : 0.f;
      v[j].z = valid > 2 ? __ldg(g + 2) : 0.f;
      v[j].w = valid > 3 ? __ldg(g + 3) : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int q = 4 * (threadIdx.x + j * kThreads);
    s[pad(q)] = v[j].x;
    s[pad(q + 1)] = v[j].y;
    s[pad(q + 2)] = v[j].z;
    s[pad(q + 3)] = v[j].w;
  }
}

// Stores staged positions q..q+3 of s at g[0..3]: one 16-byte store where
// all four are valid and g is aligned, element stores of the valid ones
// otherwise.
__device__ __forceinline__ void put_slot(const float* s, int q,
                                         float* __restrict__ g, int valid) {
  const float a = s[pad(q)], b = s[pad(q + 1)], d = s[pad(q + 2)],
              e = s[pad(q + 3)];
  if (valid >= 4 && aligned16(g)) {
    *reinterpret_cast<float4*>(g) = make_float4(a, b, d, e);
  } else {
    if (valid > 0) g[0] = a;
    if (valid > 1) g[1] = b;
    if (valid > 2) g[2] = d;
    if (valid > 3) g[3] = e;
  }
}

// Writes the staged tile s to rows [row0, row0 + R) of out, laid out as the
// input (stage_in's mirror): consecutive threads store consecutive slots.
template <int K>
__device__ __forceinline__ void stage_out(const float* s, bool row_major,
                                          long long cs,
                                          float* __restrict__ out,
                                          long long row0, int R) {
  constexpr int kSlots = K * kTile / 4 / kThreads;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int q = 4 * (threadIdx.x + j * kThreads);
    if (row_major) {
      put_slot(s, q, out + row0 * K + q, R * K - q);
    } else {
      const int c = q / kTile, r = q % kTile;
      put_slot(s, q, out + c * cs + row0 + r, R - r);
    }
  }
}

// Writes staged positions [0, len) to the contiguous run g[0, len).
template <int K>
__device__ __forceinline__ void store_run(const float* s,
                                          float* __restrict__ g, int len) {
  constexpr int kSlots = K * kTile / 4 / kThreads;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int q = 4 * (threadIdx.x + j * kThreads);
    put_slot(s, q, g + q, len - q);
  }
}

// Thread t's rows t*8 .. t*8+7 of the staged tile, in registers.
template <int K>
__device__ __forceinline__ void read_rows(const float* s, bool row_major,
                                          float (&x)[kItems][K]) {
#pragma unroll
  for (int j = 0; j < kItems; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k)
      x[j][k] = s[pad(staged<K>(row_major, threadIdx.x * kItems + j, k))];
}

template <int K>
__device__ __forceinline__ void write_rows(float* s, bool row_major,
                                           const float (&x)[kItems][K]) {
#pragma unroll
  for (int j = 0; j < kItems; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k)
      s[pad(staged<K>(row_major, threadIdx.x * kItems + j, k))] = x[j][k];
}

// Shuffle scan: lanes [0, width) end with the inclusive prefix of (hi, lo)
// over lanes 0..lane (width a power of two up to 32; the whole warp calls
// it, and lanes past width end with partial sums that nobody reads).
template <int K>
__device__ __forceinline__ void warp_scan(float (&hi)[K], float (&lo)[K],
                                          int lane, int width) {
#pragma unroll
  for (int off = 1; off < width; off <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float oh = __shfl_up_sync(kFull, hi[k], off);
      const float ol = __shfl_up_sync(kFull, lo[k], off);
      if (lane >= off) ds_add(hi[k], lo[k], oh, ol);
    }
  }
}

// Exclusive block-wide prefix (ph, pl) of the per-thread totals (hi, lo),
// and the block total (th, tl). Every thread of the block must call it.
// An inclusive shuffle scan in each warp; warp 0 scans the 8 warp totals
// the same way; each thread adds its warp's exclusive prefix in front.
template <int K>
__device__ __forceinline__ void block_scan(float (&hi)[K], float (&lo)[K],
                                           float (&ph)[K], float (&pl)[K],
                                           float (&th)[K], float (&tl)[K]) {
  // rows 0..kWarps-1: warp totals, then their exclusive prefixes; row
  // kWarps: the block total
  __shared__ float s_hi[kWarps + 1][K];
  __shared__ float s_lo[kWarps + 1][K];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_scan<K>(hi, lo, lane, 32);
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s_hi[warp][k] = hi[k];
      s_lo[warp][k] = lo[k];
    }
  }
  __syncthreads();
  if (warp == 0) {
    float wh[K], wl[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      wh[k] = lane < kWarps ? s_hi[lane][k] : 0.f;
      wl[k] = lane < kWarps ? s_lo[lane][k] : 0.f;
    }
    warp_scan<K>(wh, wl, lane, kWarps);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float eh = __shfl_up_sync(kFull, wh[k], 1);
      const float el = __shfl_up_sync(kFull, wl[k], 1);
      if (lane < kWarps) {
        s_hi[lane][k] = lane == 0 ? 0.f : eh;
        s_lo[lane][k] = lane == 0 ? 0.f : el;
      }
      if (lane == kWarps - 1) {
        s_hi[kWarps][k] = wh[k];
        s_lo[kWarps][k] = wl[k];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float eh = __shfl_up_sync(kFull, hi[k], 1);
    float el = __shfl_up_sync(kFull, lo[k], 1);
    if (lane == 0) {
      eh = 0.f;
      el = 0.f;
    }
    ph[k] = s_hi[warp][k];
    pl[k] = s_lo[warp][k];
    ds_add(ph[k], pl[k], eh, el);
    th[k] = s_hi[kWarps][k];
    tl[k] = s_lo[kWarps][k];
  }
  __syncthreads();  // s_hi/s_lo free for the next call
}

// Loads the block's tile (hi, and lo for a ds-pair input) into registers
// through the staged buffer s, and reduces each thread's rows. stage(p)
// stages the block's tile of input p into s.
template <int K, bool kPair, class Stage>
__device__ __forceinline__ void load_tile(
    Stage stage, const float* __restrict__ in_hi,
    const float* __restrict__ in_lo, bool row_major, float* s,
    float (&xh)[kItems][K], float (&xl)[kItems][K], float (&hi)[K],
    float (&lo)[K]) {
  stage(in_hi);
  __syncthreads();
  read_rows<K>(s, row_major, xh);
  if (kPair) {
    __syncthreads();
    stage(in_lo);
    __syncthreads();
    read_rows<K>(s, row_major, xl);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
#pragma unroll
      for (int k = 0; k < K; ++k) xl[j][k] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    hi[k] = 0.f;
    lo[k] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) ds_add(hi[k], lo[k], xh[j][k], xl[j][k]);
}

// The carry in front of tile b, per column: the inclusive prefix of the
// tiles before it. carry: kCarryTotals: carry_hi/lo are the (T, stride)
// tile totals and block b combines rows [0, b), in the same fixed order in
// every block (thread t adds totals t*8..t*8+7, then a block scan of the
// thread sums); kCarryScanned: their inclusive scan, block b takes row
// b - 1; kCarryNone: a single tile. Block columns k read column col0 + k of
// the totals, those at or past kv read nothing. Every thread must call it.
template <int K>
__device__ __forceinline__ void carry_in(int carry,
                                         const float* __restrict__ carry_hi,
                                         const float* __restrict__ carry_lo,
                                         long long stride, int col0, int kv,
                                         float (&run_h)[K],
                                         float (&run_l)[K]) {
  const int b = blockIdx.x;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    run_h[k] = 0.f;
    run_l[k] = 0.f;
  }
  if (carry == kCarryTotals && b > 0) {
    float ch[K], cl[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ch[k] = 0.f;
      cl[k] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int t = threadIdx.x * kItems + j;
      if (t < b) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (k < kv)
            ds_add(ch[k], cl[k], carry_hi[(long long)t * stride + col0 + k],
                   carry_lo[(long long)t * stride + col0 + k]);
      }
    }
    float eh[K], el[K];
    block_scan<K>(ch, cl, eh, el, run_h, run_l);
  } else if (carry == kCarryScanned && b > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < kv) {
        run_h[k] = carry_hi[((long long)b - 1) * stride + col0 + k];
        run_l[k] = carry_lo[((long long)b - 1) * stride + col0 + k];
      }
  }
}

// Each thread's rows of the tile, in place: the carry, then the thread's
// exclusive prefix (ph, pl) in the block, then its 8 rows one by one.
template <int K>
__device__ __forceinline__ void scan_rows(float (&run_h)[K], float (&run_l)[K],
                                          const float (&ph)[K],
                                          const float (&pl)[K],
                                          float (&xh)[kItems][K],
                                          float (&xl)[kItems][K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) ds_add(run_h[k], run_l[k], ph[k], pl[k]);
#pragma unroll
  for (int j = 0; j < kItems; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ds_add(run_h[k], run_l[k], xh[j][k], xl[j][k]);
      xh[j][k] = run_h[k];
      xl[j][k] = run_l[k];
    }
}

template <int K, bool kPair, bool kBatch>
__global__ void __launch_bounds__(kThreads)
    ds_tile_total(const float* __restrict__ in_hi,
                  const float* __restrict__ in_lo, long long n, long long cs,
                  float* __restrict__ tot_hi, float* __restrict__ tot_lo,
                  Frames fs) {
  extern __shared__ float s_tile[];
  in_hi = frame_ptr<kBatch>(in_hi, fs.in);
  in_lo = frame_ptr<kBatch>(in_lo, fs.in);
  tot_hi = frame_ptr<kBatch>(tot_hi, fs.tot);
  tot_lo = frame_ptr<kBatch>(tot_lo, fs.tot);
  const bool row_major = cs == 1;
  const long long row0 = (long long)blockIdx.x * kTile;
  const int R = (int)min((long long)kTile, n - row0);
  float xh[kItems][K], xl[kItems][K], hi[K], lo[K], ph[K], pl[K], th[K],
      tl[K];
  const auto stage = [&](const float* p) {
    stage_in<K>(p, row_major, cs, row0, R, s_tile);
  };
  load_tile<K, kPair>(stage, in_hi, in_lo, row_major, s_tile, xh, xl, hi, lo);
  block_scan<K>(hi, lo, ph, pl, th, tl);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      tot_hi[(long long)blockIdx.x * K + k] = th[k];
      tot_lo[(long long)blockIdx.x * K + k] = tl[k];
    }
  }
}

// carry: kCarryTotals: carry_hi/lo are the (T, K) tile totals, block b
// combines rows [0, b); kCarryScanned: their inclusive scan, block b takes
// row b - 1; kCarryNone: a single tile. out: hi in the input's layout, lo
// n * K floats after it; with pack (row layout), the (n + 1, 2K) prefix
// pack [0; hi | lo].
// Two blocks per SM (<= 128 registers a thread) up to K = 4: the codec's
// 256-tile pack is then one wave on 132 SMs.
template <int K, bool kPair, bool kBatch>
__global__ void __launch_bounds__(kThreads, K <= 4 ? 2 : 1)
    ds_tile_scan(const float* __restrict__ in_hi,
                 const float* __restrict__ in_lo, long long n, long long cs,
                 const float* __restrict__ carry_hi,
                 const float* __restrict__ carry_lo, int carry,
                 float* __restrict__ out, bool pack, Frames fs) {
  extern __shared__ float s_tile[];
  in_hi = frame_ptr<kBatch>(in_hi, fs.in);
  in_lo = frame_ptr<kBatch>(in_lo, fs.in);
  carry_hi = frame_ptr<kBatch>(carry_hi, fs.tot);
  carry_lo = frame_ptr<kBatch>(carry_lo, fs.tot);
  out = frame_ptr<kBatch>(out, fs.out);
  const bool row_major = cs == 1;
  const long long row0 = (long long)blockIdx.x * kTile;
  const int R = (int)min((long long)kTile, n - row0);
  const int b = blockIdx.x;
  float xh[kItems][K], xl[kItems][K], hi[K], lo[K], ph[K], pl[K], th[K],
      tl[K];
  const auto stage = [&](const float* p) {
    stage_in<K>(p, row_major, cs, row0, R, s_tile);
  };
  load_tile<K, kPair>(stage, in_hi, in_lo, row_major, s_tile, xh, xl, hi, lo);
  block_scan<K>(hi, lo, ph, pl, th, tl);
  float run_h[K], run_l[K];
  carry_in<K>(carry, carry_hi, carry_lo, K, 0, K, run_h, run_l);
  scan_rows<K>(run_h, run_l, ph, pl, xh, xl);

  // every thread read its rows before block_scan's barriers, so the staged
  // buffer is free for the outputs
  if (pack) {
    if (b == 0 && threadIdx.x < 2 * K) out[threadIdx.x] = 0.f;
    // [hi | lo] rows, 2K floats apart: half a tile of whole rows at a time
    // is one contiguous run
    constexpr int kHalf = kTile / 2;
    for (int h = 0; h < 2; ++h) {
      if (threadIdx.x / (kThreads / 2) == h) {
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int r = (threadIdx.x % (kThreads / 2)) * kItems + j;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            s_tile[pad(r * 2 * K + k)] = xh[j][k];
            s_tile[pad(r * 2 * K + K + k)] = xl[j][k];
          }
        }
      }
      __syncthreads();
      store_run<K>(s_tile, out + (1 + row0 + h * kHalf) * 2 * K,
                   max(0, min(kHalf, R - h * kHalf)) * 2 * K);
      __syncthreads();
    }
    return;
  }
  // hi, then lo, through the staged buffer to coalesced stores
  write_rows<K>(s_tile, row_major, xh);
  __syncthreads();
  stage_out<K>(s_tile, row_major, cs, out, row0, R);
  __syncthreads();
  write_rows<K>(s_tile, row_major, xl);
  __syncthreads();
  stage_out<K>(s_tile, row_major, cs, out + n * K, row0, R);
}

// -- The wide path: more than 8 columns, in column blocks ---------------------
//
// Block (b, y) takes rows [b * kTile, ...) of the columns [c0, c0 + kv),
// c0 = y * kWide, kv <= kWide (the last block is masked). It reads its
// column slice with the stride of the whole matrix and writes hi and lo to
// their own columns of the output, so the pack [0; hi | lo] of any width is
// written in place. Per column the adds are those of the path above, in the
// same order (load_tile, block_scan, carry_in, scan_rows): a column of a
// wide pack equals the same column scanned alone, bit for bit.
constexpr int kWide = 8;

// Staged position q of the column block holds element (r, c) in the order
// of staged<kWide> (row-major for the row layout, so neighbouring threads
// touch neighbouring columns of one row; a wide row is seldom 16-byte
// aligned, so these are element loads). Element (r, c) lies at
// x[r * rs + c * cs], x at the block's first row and column. Rows past R
// and columns past kv stage as 0.
__device__ __forceinline__ void wide_stage_in(const float* __restrict__ x,
                                              bool row_major, long long rs,
                                              long long cs, int R, int kv,
                                              float* s) {
  constexpr int kPer = kWide * kTile / kThreads;
#pragma unroll 8
  for (int j = 0; j < kPer; ++j) {
    const int q = threadIdx.x + j * kThreads;
    const int r = row_major ? q / kWide : q % kTile;
    const int c = row_major ? q % kWide : q / kTile;
    s[pad(q)] = r < R && c < kv ? __ldg(x + r * rs + c * cs) : 0.f;
  }
}

// wide_stage_in's mirror: the staged column block to o[r * ors + c * ocs].
__device__ __forceinline__ void wide_stage_out(const float* s, bool row_major,
                                               float* __restrict__ o,
                                               long long ors, long long ocs,
                                               int R, int kv) {
  constexpr int kPer = kWide * kTile / kThreads;
#pragma unroll 8
  for (int j = 0; j < kPer; ++j) {
    const int q = threadIdx.x + j * kThreads;
    const int r = row_major ? q / kWide : q % kTile;
    const int c = row_major ? q % kWide : q / kTile;
    if (r < R && c < kv) o[r * ors + c * ocs] = s[pad(q)];
  }
}

template <bool kPair, bool kBatch>
__global__ void __launch_bounds__(kThreads, 1)
    ds_wide_total(const float* __restrict__ in_hi,
                  const float* __restrict__ in_lo, long long n, int ncol,
                  long long rs, long long cs, float* __restrict__ tot_hi,
                  float* __restrict__ tot_lo, Frames fs) {
  extern __shared__ float s_tile[];
  in_hi = frame_ptr<kBatch>(in_hi, fs.in);
  in_lo = frame_ptr<kBatch>(in_lo, fs.in);
  tot_hi = frame_ptr<kBatch>(tot_hi, fs.tot);
  tot_lo = frame_ptr<kBatch>(tot_lo, fs.tot);
  const bool row_major = cs == 1;
  const long long row0 = (long long)blockIdx.x * kTile;
  const int R = (int)min((long long)kTile, n - row0);
  const int c0 = blockIdx.y * kWide;
  const int kv = min(kWide, ncol - c0);
  const long long off = row0 * rs + c0 * cs;
  float xh[kItems][kWide], xl[kItems][kWide], hi[kWide], lo[kWide],
      ph[kWide], pl[kWide], th[kWide], tl[kWide];
  const auto stage = [&](const float* p) {
    wide_stage_in(p + off, row_major, rs, cs, R, kv, s_tile);
  };
  load_tile<kWide, kPair>(stage, in_hi, in_lo, row_major, s_tile, xh, xl, hi,
                          lo);
  block_scan<kWide>(hi, lo, ph, pl, th, tl);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kWide; ++k)
      if (k < kv) {
        tot_hi[(long long)blockIdx.x * ncol + c0 + k] = th[k];
        tot_lo[(long long)blockIdx.x * ncol + c0 + k] = tl[k];
      }
  }
}

// carry as in ds_tile_scan, over (T, ncol) totals. out_hi / out_lo: row 0,
// column 0 of hi and lo, strides (ors, ocs); zero_row, unless null, gets
// the pack's zero row (its 2 * ncol floats).
template <bool kPair, bool kBatch>
__global__ void __launch_bounds__(kThreads, 1)
    ds_wide_scan(const float* __restrict__ in_hi,
                 const float* __restrict__ in_lo, long long n, int ncol,
                 long long rs, long long cs, const float* __restrict__ carry_hi,
                 const float* __restrict__ carry_lo, int carry,
                 float* __restrict__ out_hi, float* __restrict__ out_lo,
                 long long ors, long long ocs, float* __restrict__ zero_row,
                 Frames fs) {
  extern __shared__ float s_tile[];
  in_hi = frame_ptr<kBatch>(in_hi, fs.in);
  in_lo = frame_ptr<kBatch>(in_lo, fs.in);
  carry_hi = frame_ptr<kBatch>(carry_hi, fs.tot);
  carry_lo = frame_ptr<kBatch>(carry_lo, fs.tot);
  out_hi = frame_ptr<kBatch>(out_hi, fs.out);
  out_lo = frame_ptr<kBatch>(out_lo, fs.out);
  zero_row = frame_ptr<kBatch>(zero_row, fs.out);
  const bool row_major = cs == 1;
  const long long row0 = (long long)blockIdx.x * kTile;
  const int R = (int)min((long long)kTile, n - row0);
  const int c0 = blockIdx.y * kWide;
  const int kv = min(kWide, ncol - c0);
  const long long off = row0 * rs + c0 * cs;
  float xh[kItems][kWide], xl[kItems][kWide], hi[kWide], lo[kWide],
      ph[kWide], pl[kWide], th[kWide], tl[kWide];
  const auto stage = [&](const float* p) {
    wide_stage_in(p + off, row_major, rs, cs, R, kv, s_tile);
  };
  load_tile<kWide, kPair>(stage, in_hi, in_lo, row_major, s_tile, xh, xl, hi,
                          lo);
  block_scan<kWide>(hi, lo, ph, pl, th, tl);
  float run_h[kWide], run_l[kWide];
  carry_in<kWide>(carry, carry_hi, carry_lo, ncol, c0, kv, run_h, run_l);
  scan_rows<kWide>(run_h, run_l, ph, pl, xh, xl);

  if (zero_row != nullptr && blockIdx.x == 0 && threadIdx.x < kv) {
    zero_row[c0 + threadIdx.x] = 0.f;
    zero_row[ncol + c0 + threadIdx.x] = 0.f;
  }
  // the staged buffer is free (see ds_tile_scan): hi, then lo through it
  const long long o = row0 * ors + c0 * ocs;
  write_rows<kWide>(s_tile, row_major, xh);
  __syncthreads();
  wide_stage_out(s_tile, row_major, out_hi + o, ors, ocs, R, kv);
  __syncthreads();
  write_rows<kWide>(s_tile, row_major, xl);
  __syncthreads();
  wide_stage_out(s_tile, row_major, out_lo + o, ors, ocs, R, kv);
}

template <int K, bool kPair, bool kBatch>
size_t stage_bytes() {
  const size_t bytes = sizeof(float) * stage_floats(K);
  static bool raised = false;  // above 48 KB needs the opt-in, once
  if (bytes > 48 * 1024 && !raised) {
    cudaFuncSetAttribute(ds_tile_total<K, kPair, kBatch>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    cudaFuncSetAttribute(ds_tile_scan<K, kPair, kBatch>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    raised = true;
  }
  return bytes;
}

// Floats of scratch that scan_level needs for n rows of k columns (one
// frame).
long long scratch_need(long long n, int k) {
  const long long t = (n + kTile - 1) / kTile;
  if (t <= 1) return 0;
  if (t <= kMaxCarryTiles) return 2 * t * k;
  return 4 * t * k + scratch_need(t, k);
}

// cs: the input's column stride (1: row layout, rows K floats apart;
// otherwise rows are 1 apart). Scratch layout per level: tile totals hi,
// lo (T * K each), and beyond kMaxCarryTiles their scan hi, lo and the
// next level's scratch. nb frames (grid z), fs their strides; every
// scratch-derived pointer keeps the scratch's frame stride, so a deeper
// level's input, output and scratch all step by fs.tot.
template <int K, bool kPair, bool kBatch>
void scan_level(const float* in_hi, const float* in_lo, long long n,
                long long cs, float* out, bool pack, float* scratch,
                cudaStream_t st, int nb, Frames fs) {
  const size_t smem = stage_bytes<K, kPair, kBatch>();
  const long long t = (n + kTile - 1) / kTile;
  const dim3 grid((unsigned)t, 1, (unsigned)nb);
  if (t <= 1) {
    ds_tile_scan<K, kPair, kBatch><<<grid, kThreads, smem, st>>>(
        in_hi, in_lo, n, cs, nullptr, nullptr, kCarryNone, out, pack, fs);
    return;
  }
  float* tot_hi = scratch;
  float* tot_lo = tot_hi + t * K;
  ds_tile_total<K, kPair, kBatch><<<grid, kThreads, smem, st>>>(
      in_hi, in_lo, n, cs, tot_hi, tot_lo, fs);
  if (t <= kMaxCarryTiles) {
    ds_tile_scan<K, kPair, kBatch><<<grid, kThreads, smem, st>>>(
        in_hi, in_lo, n, cs, tot_hi, tot_lo, kCarryTotals, out, pack, fs);
    return;
  }
  // the totals' inclusive scan: hi, then lo, then the next level's scratch
  float* inc = tot_lo + t * K;
  scan_level<K, true, kBatch>(tot_hi, tot_lo, t, 1, inc, false,
                              inc + 2 * t * K, st, nb,
                              Frames{fs.tot, fs.tot, fs.tot});
  ds_tile_scan<K, kPair, kBatch><<<grid, kThreads, smem, st>>>(
      in_hi, in_lo, n, cs, inc, inc + t * K, kCarryScanned, out, pack, fs);
}

template <bool kPair, bool kBatch>
size_t wide_stage_bytes() {
  const size_t bytes = sizeof(float) * stage_floats(kWide);  // 67.6 KB
  static bool raised = false;
  if (!raised) {
    cudaFuncSetAttribute(ds_wide_total<kPair, kBatch>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    cudaFuncSetAttribute(ds_wide_scan<kPair, kBatch>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    raised = true;
  }
  return bytes;
}

// scan_level for ncol > kWide columns, on a grid of (tiles, column blocks,
// frames). Input element (r, c) at in[r * rs + c * cs]; output hi (r, c) at
// out_hi[r * ors + c * ocs], lo likewise from out_lo. Scratch as in
// scan_level, with ncol columns to a totals row.
template <bool kPair, bool kBatch>
void wide_level(const float* in_hi, const float* in_lo, long long n, int ncol,
                long long rs, long long cs, float* out_hi, float* out_lo,
                long long ors, long long ocs, float* zero_row, float* scratch,
                cudaStream_t st, int nb, Frames fs) {
  const size_t smem = wide_stage_bytes<kPair, kBatch>();
  const long long t = (n + kTile - 1) / kTile;
  const dim3 grid((unsigned)t, (unsigned)((ncol + kWide - 1) / kWide),
                  (unsigned)nb);
  if (t <= 1) {
    ds_wide_scan<kPair, kBatch><<<grid, kThreads, smem, st>>>(
        in_hi, in_lo, n, ncol, rs, cs, nullptr, nullptr, kCarryNone, out_hi,
        out_lo, ors, ocs, zero_row, fs);
    return;
  }
  float* tot_hi = scratch;
  float* tot_lo = tot_hi + t * ncol;
  ds_wide_total<kPair, kBatch><<<grid, kThreads, smem, st>>>(
      in_hi, in_lo, n, ncol, rs, cs, tot_hi, tot_lo, fs);
  if (t <= kMaxCarryTiles) {
    ds_wide_scan<kPair, kBatch><<<grid, kThreads, smem, st>>>(
        in_hi, in_lo, n, ncol, rs, cs, tot_hi, tot_lo, kCarryTotals, out_hi,
        out_lo, ors, ocs, zero_row, fs);
    return;
  }
  float* inc = tot_lo + t * ncol;
  wide_level<true, kBatch>(tot_hi, tot_lo, t, ncol, ncol, 1, inc,
                           inc + t * ncol, ncol, 1, nullptr,
                           inc + 2 * t * ncol, st, nb,
                           Frames{fs.tot, fs.tot, fs.tot});
  ds_wide_scan<kPair, kBatch><<<grid, kThreads, smem, st>>>(
      in_hi, in_lo, n, ncol, rs, cs, inc, inc + t * ncol, kCarryScanned,
      out_hi, out_lo, ors, ocs, zero_row, fs);
}

// The launches of one scan over nb frames of n rows and k columns (element
// (r, c) of frame z at x[z * fs.in + r * rs + c * cs]), as ds_cumsum_f32
// describes them for one frame. Returns cudaGetLastError() after them.
template <bool kBatch>
int launch_scan(const float* x, long long n, int k, long long rs,
                long long cs, bool pack, float* out, float* scratch,
                cudaStream_t st, int nb, Frames fs) {
  if (k > kWide) {
    // hi keeps x's strides; the pack's hi starts at row 1, its lo k after
    if (pack)
      wide_level<false, kBatch>(x, nullptr, n, k, rs, cs, out + 2 * k,
                                out + 3 * k, 2 * k, 1, out, scratch, st, nb,
                                fs);
    else
      wide_level<false, kBatch>(x, nullptr, n, k, rs, cs, out, out + n * k,
                                rs, cs, nullptr, scratch, st, nb, fs);
    return static_cast<int>(cudaGetLastError());
  }
#define DS_SCAN_CASE(K)                                                   \
  case K:                                                                 \
    scan_level<K, false, kBatch>(x, nullptr, n, cs, out, pack, scratch, st, \
                                 nb, fs);                                 \
    break;
  switch (k) {
    DS_SCAN_CASE(1)
    DS_SCAN_CASE(2)
    DS_SCAN_CASE(3)
    DS_SCAN_CASE(4)
    DS_SCAN_CASE(5)
    DS_SCAN_CASE(6)
    DS_SCAN_CASE(7)
    DS_SCAN_CASE(8)
  }
#undef DS_SCAN_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Inclusive compensated prefix sums along the rows of x (n rows, k >= 1
// columns, element (r, c) at x[r * rs + c * cs]: the row layout rs == k,
// cs == 1 or the column layout rs == 1, cs == n). Without pack, out gets hi
// in x's layout and lo n * k floats after it; with pack (row layout only),
// the (n + 1, 2k) matrix of a zero row, then rows [hi | lo]. Up to 8
// columns one block takes all of a tile's columns; more go through the
// wide path's column blocks. scratch holds scratch_floats floats. Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() after
// the launches, or without launching -1 for k < 1, -2 for an unsupported
// layout, -3 for too little scratch.
int ds_cumsum_f32(const float* x, long long n, int k, long long rs,
                  long long cs, int pack, float* out, float* scratch,
                  long long scratch_floats, void* stream) {
  if (k < 1) return -1;
  const bool row = rs == k && cs == 1;
  if (!(row || (rs == 1 && cs == n)) || (pack && !row)) return -2;
  if (scratch_floats < scratch_need(n, k)) return -3;
  return launch_scan<false>(x, n, k, rs, cs, pack != 0, out, scratch,
                            static_cast<cudaStream_t>(stream), 1,
                            Frames{0, 0, 0});
}

// The batched entry's bound on the card: bytes, as for one frame, times B.
// At the dataset path's (4, 2^20, 4) pack the stack reads 67.1 MB and
// writes 134.2 MB, ~0.060 ms at 3.35 TB/s. The grid holds B times the
// single entry's blocks, so a batch of frames fills the card in more waves
// of the same blocks.
//
// x: b contiguous (n, k) row-layout frames. Without pack, out gets frame
// z's hi at out + 2 * z * n * k and its lo n * k floats after it (a
// (b, 2, n, k) block); with pack, the (b, n + 1, 2k) stack of packs, each
// a zero row, then rows [hi | lo]. scratch holds scratch_floats floats, of
// which each frame takes scratch_need(n, k). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launches, or
// without launching -1 for k < 1, -3 for too little scratch, -4 for a
// frame count outside [1, 65535] (the grid's z extent).
int ds_cumsum_batched_f32(const float* x, long long b, long long n, int k,
                          int pack, float* out, float* scratch,
                          long long scratch_floats, void* stream) {
  if (k < 1) return -1;
  if (b < 1 || b > 65535) return -4;
  const long long need = scratch_need(n, k);
  if (scratch_floats < b * need) return -3;
  const long long out_fs = pack ? (n + 1) * 2 * k : 2 * n * k;
  return launch_scan<true>(x, n, k, k, 1, pack != 0, out, scratch,
                           static_cast<cudaStream_t>(stream), (int)b,
                           Frames{n * k, need, out_fs});
}

}  // extern "C"
