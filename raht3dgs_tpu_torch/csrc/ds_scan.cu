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
// pack (a whole 57-column tile would need 481 KB of shared memory, over the
// 227 KB a Hopper block may have). At (2^19, 57) the bound is 359 MB of
// traffic, 0.107 ms at 3.35 TB/s. The column blocks of a tile are
// neighbours in launch order (a linear blockIdx.x), so they run together
// and can share in L2 the 32-byte sectors their slices of a row straddle. A
// block stages its 73.7 KB slice with cp.async, the whole tile in flight and
// no register holding it (16-byte copies where the layout is aligned,
// 4-byte ones otherwise); each thread sums and scans its 8 rows from the
// staged slots, writing hi back in place and keeping lo in registers, so
// the scan pass runs two blocks an SM and the totals pass three; results
// leave in 16-, 8- or 4-byte stores as the output's alignment allows. What
// it leaves (scripts/scan_phase_probe.py): in the row layout the copies
// alone take most of the time, a column block's 32-byte slices of every
// row moving at a fraction of the rate of the transposed layout's
// contiguous column runs; reading and writing whole rows needs the tile's
// column blocks to share them (a thread-block cluster). After that, the
// three block scans a tile and the second read of the input (a single
// pass).
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
__device__ __forceinline__ void carry_at(int b, int carry,
                                         const float* __restrict__ carry_hi,
                                         const float* __restrict__ carry_lo,
                                         long long stride, int col0, int kv,
                                         float (&run_h)[K],
                                         float (&run_l)[K]) {
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

// carry_at for the tile of blockIdx.x.
template <int K>
__device__ __forceinline__ void carry_in(int carry,
                                         const float* __restrict__ carry_hi,
                                         const float* __restrict__ carry_lo,
                                         long long stride, int col0, int kv,
                                         float (&run_h)[K],
                                         float (&run_l)[K]) {
  carry_at<K>(blockIdx.x, carry, carry_hi, carry_lo, stride, col0, kv, run_h,
              run_l);
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
// Block (tile b, column block y) takes rows [b * kTile, ...) of the columns
// [c0, c0 + kv), c0 = y * kWide, kv <= kWide (the last column block is
// masked). blockIdx.x is b * ncb + y over the ncb column blocks, so the
// blocks of one tile are neighbours in launch order and run together, and
// the 32-byte sectors that their slices of a row share can be found in L2
// by the neighbour, read or partly written. A block reads its column slice
// with the stride of the whole matrix and writes hi and lo to their own
// columns of the output, so the pack [0; hi | lo] of any width is written
// in place. Per column the adds are those of the path above, in the same
// order (the thread's 8 rows, block_scan, carry_at, the rows again from the
// carry): a column of a wide pack equals the same column scanned alone, bit
// for bit.
constexpr int kWide = 8;
// Floats of one staged column block, pad words included (wide_word): 73.7 KB,
// three blocks to an SM's 228 KB.
constexpr int kWideStage = kWide * kTile + kWide * kTile / 8;

// Shared word of element (r, c) of the staged column block, in the input's
// layout. Row layout: row-major with 4 pad words after every 8 rows, so
// thread t's rows 8t..8t+7 are the 64 floats at 68t. Column layout:
// column-major with 4 pad words after every 32 rows, so thread t's 8 rows
// of a column are 8 consecutive floats. Either way 16-byte accesses by 8
// neighbouring threads fall on 32 distinct banks, and every run of 4 along
// the contiguous axis that starts at a multiple of 4 is 16-byte aligned.
__device__ __forceinline__ int wide_word(bool row_major, int r, int c) {
  return row_major ? (kWide * 8 + 4) * (r >> 3) + kWide * (r & 7) + c
                   : c * (kTile + kTile / 8) + r + 4 * (r >> 5);
}

// cp.async of V floats (V = 1, 2 or 4) from g to shared s, of which the
// first `valid` are read and the rest filled with 0; g must be a valid
// address even where valid is 0.
template <int V>
__device__ __forceinline__ void cp_async(float* s, const float* g,
                                         int valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(s));
  if constexpr (V == 4) {  // 16 bytes bypass L1
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(g), "r"(4 * valid)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(g), "n"(4 * V), "r"(4 * valid)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The widest V in {4, 2, 1} whose runs of V floats, starting at p and at
// multiples of V along the contiguous axis, step floats apart along the
// other, are all 4V-byte aligned.
__device__ __forceinline__ int wide_vec(const float* p, long long step) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15) == 0 && step % 4 == 0) return 4;
  if ((a & 7) == 0 && step % 2 == 0) return 2;
  return 1;
}

// Unit u of the column block: V floats along the contiguous axis (columns
// in the row layout, rows in the column layout), neighbouring units on
// neighbouring addresses. Sets its first element (r, c) and returns how
// many of its V floats lie inside the block's R rows and kv columns.
template <int V>
__device__ __forceinline__ int wide_unit(bool row_major, int u, int R, int kv,
                                         int& r, int& c) {
  if (row_major) {
    r = u / (kWide / V);
    c = u % (kWide / V) * V;
    return r < R ? max(0, min(V, kv - c)) : 0;
  }
  c = u / (kTile / V);
  r = u % (kTile / V) * V;
  return c < kv ? max(0, min(V, R - r)) : 0;
}

// Issues the copies of the column block (element (r, c) at x[r * rs + c *
// cs], x at the block's first row and column) into the staged s: the whole
// tile in flight at once, no register holding it. Rows past R and columns
// past kv stage as 0.
template <int V>
__device__ __forceinline__ void wide_copy_in(const float* __restrict__ x,
                                             bool row_major, long long rs,
                                             long long cs, int R, int kv,
                                             float* s) {
  constexpr int kUnits = kWide * kTile / V / kThreads;
#pragma unroll 16
  for (int j = 0; j < kUnits; ++j) {
    int r, c;
    const int valid =
        wide_unit<V>(row_major, threadIdx.x + j * kThreads, R, kv, r, c);
    cp_async<V>(s + wide_word(row_major, r, c),
                valid > 0 ? x + r * rs + c * cs : x, valid);
  }
}

__device__ __forceinline__ void wide_stage_in(const float* __restrict__ x,
                                              bool row_major, long long rs,
                                              long long cs, int R, int kv,
                                              float* s) {
  switch (wide_vec(x, row_major ? rs : cs)) {
    case 4:
      wide_copy_in<4>(x, row_major, rs, cs, R, kv, s);
      break;
    case 2:
      wide_copy_in<2>(x, row_major, rs, cs, R, kv, s);
      break;
    default:
      wide_copy_in<1>(x, row_major, rs, cs, R, kv, s);
  }
}

// wide_copy_in's mirror: the staged column block to o[r * ors + c * ocs],
// V floats a store where all V are inside the block.
template <int V>
__device__ __forceinline__ void wide_copy_out(const float* s, bool row_major,
                                              float* __restrict__ o,
                                              long long ors, long long ocs,
                                              int R, int kv) {
  constexpr int kUnits = kWide * kTile / V / kThreads;
#pragma unroll 16
  for (int j = 0; j < kUnits; ++j) {
    int r, c;
    const int valid =
        wide_unit<V>(row_major, threadIdx.x + j * kThreads, R, kv, r, c);
    const float* p = s + wide_word(row_major, r, c);
    float* g = o + r * ors + c * ocs;
    if (valid == V) {
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(g) = *reinterpret_cast<const float4*>(p);
      } else if constexpr (V == 2) {
        *reinterpret_cast<float2*>(g) = *reinterpret_cast<const float2*>(p);
      } else {
        *g = *p;
      }
    } else {
      for (int e = 0; e < valid; ++e) g[e] = p[e];
    }
  }
}

__device__ __forceinline__ void wide_stage_out(const float* s, bool row_major,
                                               float* __restrict__ o,
                                               long long ors, long long ocs,
                                               int R, int kv) {
  switch (wide_vec(o, row_major ? ors : ocs)) {
    case 4:
      wide_copy_out<4>(s, row_major, o, ors, ocs, R, kv);
      break;
    case 2:
      wide_copy_out<2>(s, row_major, o, ors, ocs, R, kv);
      break;
    default:
      wide_copy_out<1>(s, row_major, o, ors, ocs, R, kv);
  }
}

// Line i of the thread's 8 rows x 8 columns: row 8t + i (row layout) or
// column i (column layout), 8 floats at two 16-byte aligned words.
__device__ __forceinline__ int wide_line(bool row_major, int i) {
  return row_major ? wide_word(true, threadIdx.x * kItems + i, 0)
                   : wide_word(false, threadIdx.x * kItems, i);
}

__device__ __forceinline__ void load_line(const float* s, int w,
                                          float (&v)[kWide]) {
  const float4 a = *reinterpret_cast<const float4*>(s + w);
  const float4 b = *reinterpret_cast<const float4*>(s + w + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store_line(float* s, int w,
                                           const float (&v)[kWide]) {
  *reinterpret_cast<float4*>(s + w) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(s + w + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// The thread's sums (hi, lo) of its 8 rows per column, read from the staged
// block (hi from s, lo from s2 for a ds-pair input): load_tile's adds.
template <bool kPair>
__device__ __forceinline__ void wide_row_sums(const float* s, const float* s2,
                                              bool row_major,
                                              float (&hi)[kWide],
                                              float (&lo)[kWide]) {
#pragma unroll
  for (int k = 0; k < kWide; ++k) {
    hi[k] = 0.f;
    lo[k] = 0.f;
  }
  float vh[kWide], vl[kWide];
#pragma unroll
  for (int k = 0; k < kWide; ++k) vl[k] = 0.f;
  if (row_major) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {  // row j: every column's j-th add
      load_line(s, wide_line(true, j), vh);
      if (kPair) load_line(s2, wide_line(true, j), vl);
#pragma unroll
      for (int k = 0; k < kWide; ++k) ds_add(hi[k], lo[k], vh[k], vl[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kWide; ++k) {  // column k: its 8 adds
      load_line(s, wide_line(false, k), vh);
      if (kPair) load_line(s2, wide_line(false, k), vl);
#pragma unroll
      for (int j = 0; j < kItems; ++j) ds_add(hi[k], lo[k], vh[j], vl[j]);
    }
  }
}

// scan_rows on the staged block: from the running (rh, rl), the thread's 8
// rows one by one; each result's hi goes back into the element's own slot
// of s, its lo into that of s2 (kPair) or into lo_out[line][element], so
// no register holds the input. Only the thread's own slots are touched.
template <bool kPair>
__device__ __forceinline__ void wide_scan_rows(float* s, float* s2,
                                               bool row_major,
                                               float (&rh)[kWide],
                                               float (&rl)[kWide],
                                               float (&lo_out)[kItems][kWide]) {
  float vh[kWide], vl[kWide];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int w = wide_line(row_major, i);
    load_line(s, w, vh);
    if (kPair) {
      load_line(s2, w, vl);
    } else {
#pragma unroll
      for (int k = 0; k < kWide; ++k) vl[k] = 0.f;
    }
    if (row_major) {  // row i, every column
#pragma unroll
      for (int k = 0; k < kWide; ++k) {
        ds_add(rh[k], rl[k], vh[k], vl[k]);
        vh[k] = rh[k];
        vl[k] = rl[k];
      }
    } else {          // column i, every row
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        ds_add(rh[i], rl[i], vh[j], vl[j]);
        vh[j] = rh[i];
        vl[j] = rl[i];
      }
    }
    store_line(s, w, vh);
    if (kPair) {
      store_line(s2, w, vl);
    } else {
#pragma unroll
      for (int e = 0; e < kWide; ++e) lo_out[i][e] = vl[e];
    }
  }
}

// The column block of blockIdx.x: tile b, first column c0, R rows, kv
// columns.
struct WideBlock {
  long long row0;
  int b, c0, R, kv;
};

__device__ __forceinline__ WideBlock wide_block(long long n, int ncol) {
  const unsigned ncb = (ncol + kWide - 1) / kWide;
  WideBlock w;
  w.b = (int)(blockIdx.x / ncb);
  w.c0 = (int)(blockIdx.x % ncb) * kWide;
  w.row0 = (long long)w.b * kTile;
  w.R = (int)min((long long)kTile, n - w.row0);
  w.kv = min(kWide, ncol - w.c0);
  return w;
}

// Stages the block's column slice of in_hi into s (and of in_lo into s2),
// the copies left in flight.
template <bool kPair>
__device__ __forceinline__ void wide_issue(const float* __restrict__ in_hi,
                                           const float* __restrict__ in_lo,
                                           bool row_major, long long rs,
                                           long long cs, const WideBlock& w,
                                           float* s, float* s2) {
  const long long off = w.row0 * rs + w.c0 * cs;
  wide_stage_in(in_hi + off, row_major, rs, cs, w.R, w.kv, s);
  if (kPair) wide_stage_in(in_lo + off, row_major, rs, cs, w.R, w.kv, s2);
}

// Registers: up to three blocks an SM (80 a thread) for one input, the
// staged tile's 73.7 KB being the limit.
template <bool kPair, bool kBatch>
__global__ void __launch_bounds__(kThreads, kPair ? 1 : 3)
    ds_wide_total(const float* __restrict__ in_hi,
                  const float* __restrict__ in_lo, long long n, int ncol,
                  long long rs, long long cs, float* __restrict__ tot_hi,
                  float* __restrict__ tot_lo, Frames fs) {
  extern __shared__ __align__(16) float s_wide[];
  in_hi = frame_ptr<kBatch>(in_hi, fs.in);
  in_lo = frame_ptr<kBatch>(in_lo, fs.in);
  tot_hi = frame_ptr<kBatch>(tot_hi, fs.tot);
  tot_lo = frame_ptr<kBatch>(tot_lo, fs.tot);
  float* s2 = s_wide + kWideStage;
  const bool row_major = cs == 1;
  const WideBlock w = wide_block(n, ncol);
  wide_issue<kPair>(in_hi, in_lo, row_major, rs, cs, w, s_wide, s2);
  cp_async_wait_all();
  __syncthreads();
  float hi[kWide], lo[kWide], ph[kWide], pl[kWide], th[kWide], tl[kWide];
  wide_row_sums<kPair>(s_wide, s2, row_major, hi, lo);
  block_scan<kWide>(hi, lo, ph, pl, th, tl);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kWide; ++k)
      if (k < w.kv) {
        tot_hi[(long long)w.b * ncol + w.c0 + k] = th[k];
        tot_lo[(long long)w.b * ncol + w.c0 + k] = tl[k];
      }
  }
}

// carry as in ds_tile_scan, over (T, ncol) totals. out_hi / out_lo: row 0,
// column 0 of hi and lo, strides (ors, ocs), in the input's layout;
// zero_row, unless null, gets the pack's zero row (its 2 * ncol floats).
// The carry reads the totals while the tile's copies are in flight.
// Registers: two blocks an SM (128 a thread), the lo results being 64 of
// them.
template <bool kPair, bool kBatch>
__global__ void __launch_bounds__(kThreads, kPair ? 1 : 2)
    ds_wide_scan(const float* __restrict__ in_hi,
                 const float* __restrict__ in_lo, long long n, int ncol,
                 long long rs, long long cs, const float* __restrict__ carry_hi,
                 const float* __restrict__ carry_lo, int carry,
                 float* __restrict__ out_hi, float* __restrict__ out_lo,
                 long long ors, long long ocs, float* __restrict__ zero_row,
                 Frames fs) {
  extern __shared__ __align__(16) float s_wide[];
  in_hi = frame_ptr<kBatch>(in_hi, fs.in);
  in_lo = frame_ptr<kBatch>(in_lo, fs.in);
  carry_hi = frame_ptr<kBatch>(carry_hi, fs.tot);
  carry_lo = frame_ptr<kBatch>(carry_lo, fs.tot);
  out_hi = frame_ptr<kBatch>(out_hi, fs.out);
  out_lo = frame_ptr<kBatch>(out_lo, fs.out);
  zero_row = frame_ptr<kBatch>(zero_row, fs.out);
  float* s2 = s_wide + kWideStage;
  const bool row_major = cs == 1;
  const WideBlock w = wide_block(n, ncol);
  wide_issue<kPair>(in_hi, in_lo, row_major, rs, cs, w, s_wide, s2);
  float run_h[kWide], run_l[kWide];
  carry_at<kWide>(w.b, carry, carry_hi, carry_lo, ncol, w.c0, w.kv, run_h,
                  run_l);
  cp_async_wait_all();
  __syncthreads();
  {
    float hi[kWide], lo[kWide], ph[kWide], pl[kWide], th[kWide], tl[kWide];
    wide_row_sums<kPair>(s_wide, s2, row_major, hi, lo);
    block_scan<kWide>(hi, lo, ph, pl, th, tl);
#pragma unroll
    for (int k = 0; k < kWide; ++k) ds_add(run_h[k], run_l[k], ph[k], pl[k]);
  }
  if (zero_row != nullptr && w.b == 0 && threadIdx.x < w.kv) {
    zero_row[w.c0 + threadIdx.x] = 0.f;
    zero_row[ncol + w.c0 + threadIdx.x] = 0.f;
  }
  float lo_out[kItems][kWide];
  wide_scan_rows<kPair>(s_wide, s2, row_major, run_h, run_l, lo_out);
  // hi, then lo, from the staged slots to the output
  const long long o = w.row0 * ors + w.c0 * ocs;
  __syncthreads();
  wide_stage_out(s_wide, row_major, out_hi + o, ors, ocs, w.R, w.kv);
  if (kPair) {
    wide_stage_out(s2, row_major, out_lo + o, ors, ocs, w.R, w.kv);
    return;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    store_line(s_wide, wide_line(row_major, i), lo_out[i]);
  __syncthreads();
  wide_stage_out(s_wide, row_major, out_lo + o, ors, ocs, w.R, w.kv);
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

// Shared memory of a wide block: one staged column block a staged input.
// The carveout asks for the SM's whole 228 KB as shared memory, room for
// three one-input blocks.
template <bool kPair, bool kBatch>
size_t wide_stage_bytes() {
  const size_t bytes = sizeof(float) * kWideStage * (kPair ? 2 : 1);
  static bool raised = false;
  if (!raised) {
    for (const void* f : {(const void*)ds_wide_total<kPair, kBatch>,
                          (const void*)ds_wide_scan<kPair, kBatch>}) {
      cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
      cudaFuncSetAttribute(f, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
    }
    raised = true;
  }
  return bytes;
}

// scan_level for ncol > kWide columns, on a grid of (tiles x column blocks,
// frames), the column block varying fastest along x. Input element (r, c)
// at in[r * rs + c * cs]; output hi (r, c) at out_hi[r * ors + c * ocs], lo
// likewise from out_lo. Scratch as in scan_level, with ncol columns to a
// totals row.
template <bool kPair, bool kBatch>
void wide_level(const float* in_hi, const float* in_lo, long long n, int ncol,
                long long rs, long long cs, float* out_hi, float* out_lo,
                long long ors, long long ocs, float* zero_row, float* scratch,
                cudaStream_t st, int nb, Frames fs) {
  const size_t smem = wide_stage_bytes<kPair, kBatch>();
  const long long t = (n + kTile - 1) / kTile;
  const dim3 grid((unsigned)(t * ((ncol + kWide - 1) / kWide)), 1,
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
