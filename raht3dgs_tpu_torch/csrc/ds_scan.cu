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
// tile totals combine are constants, and no value is combined atomically.
// The one atomic, the batched entry's ticket counter, orders only when
// blocks run: which block scans which tile, and when it may read the
// totals of the tiles before it; the totals it then combines, and their
// order, are fixed. So one column scanned alone or inside a wider pack
// gives the same bits, every run gives the same bits, and integer-valued
// lanes whose partial sums stay below 2^24 are exact.
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
// costs a launch. A single pass cannot use a look-back (a block adding
// whichever predecessors' partial sums have arrived associates by timing);
// the batched entry's one pass below instead waits for every total the
// fixed reduction takes. The pack's [hi | lo] rows are staged whole, half a
// tile at a time, and stored as one contiguous run.
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
// The batched entry replaces _scan_kernel under jax.vmap, as the JAX
// package's batched codec (parallel/sharding.py) runs it: a pallas_call
// under vmap gains a leading grid axis over the frames. It scans B frames
// of one shape; nothing crosses a frame, and a frame's blocks do exactly
// the single entry's adds, so frame b's output is the single entry's on
// x[b], bit for bit. With 2 to 8 columns and 2 to 2048 tiles a frame (the
// dataset path's (4, 2^20, 4) pack) it is one pass, ds_tile_onepass: a
// stack larger than L2 (64 MiB at that pack) would otherwise be read twice
// from device memory, 268 MB of traffic against the function's 201 MB. Each block takes a ticket from a counter
// (frame-major), never its blockIdx: the hardware does not start blocks in
// blockIdx order, and a block waiting on a tile whose block had not
// started could hold the SM that block needs; with tickets a block waits
// only on tiles whose blocks are running and publish without waiting. It
// stages its tile with 16-byte cp.async, takes the tile's total and
// publishes it as a record [hi | lo] of 2K floats, then st.release of the
// tile's flag. Warp 0 then polls the flags of the tiles before it (relaxed
// loads, 8 in flight a lane), one fence.acq_rel follows, and the barrier
// passes the acquire on to the block, whose threads read the records at
// L2 (ld.global.cg, 16 bytes a load: read one value a load, or through the
// read-only path, the carry took 10 us a tile) and combine them in
// carry_at's order. Rows are scanned from the staged tile, hi in place, lo
// in a second buffer (pack) or registers. Three blocks an SM at K = 4. The
// flags and the counter are zeroed on the stream before each launch. What
// it leaves: each tile's chain (ticket, load, total, publish, poll, fence,
// records, scan, store) is a series of dependent round trips that lengthen
// under load (~20 us a tile at the (4, 2^20, 4) pack), and shared memory
// holds only three tiles an SM while they wait, so the pack runs at about
// half its bound. Other shapes, one column among them (the (4, 2^20, 1)
// weight scans, whose 16 MiB stack the second pass reads from L2), run the
// single entry's passes with the frame on blockIdx.z (the kBatch = true
// instances; the single entry's are kBatch = false, compiled without the
// frame offsets).

// The sharded entry (ds_shard_pass_f32) replaces the same kernel under the
// JAX package's sp axis, where XLA shards the scan's rows over devices. A
// matrix (or a stack) whose rows lie in shards, several of them possibly on
// one device, is scanned to the single entry's bits on the whole: one launch
// a pass a device over all its shards' tiles, the tile totals written in
// place at their global index, and a persistent scan pass whose
// asynchronous copies bring one tile while another is scanned and stored
// ("The sharded entry" below).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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
  carry_at<K>(b, carry, carry_hi, carry_lo, K, 0, K, run_h, run_l);
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

// -- The batched entry's one pass: 2 to 8 columns, 2 to 2048 tiles a frame ---
//
// Block d of a launch takes ticket d from a counter: frame d / T, tile
// d % T. It stages its tile in shared memory once, takes the tile's
// per-column (hi, lo) total (load_tile's adds and block_scan), publishes
// it (the tile's record, then st.release of its flag), waits until the
// tiles before it in its frame have published theirs (warp 0 polls their
// flags, then an acquire fence and a barrier), combines their totals with
// carry_at's kCarryTotals reduction and scans its rows from the staged
// tile with scan_rows' adds. Hi goes back into the staged slots and lo
// into a second buffer (pack) or registers, and both leave in coalesced
// stores.

// Shared word of float g of a staged run of rows of K floats: 4 pad words
// after every 8 rows, so thread t's rows 8t..8t+7 are the 8K floats at
// (8K + 4) t, 16-byte aligned, and the 16-byte words that 8 neighbouring
// threads read at the same offset fall on distinct banks ((2K + 1) t mod 8
// is a permutation).
template <int K>
__device__ __forceinline__ int one_word(int g) {
  return g + 4 * (g / (8 * K));
}

// Floats of one staged run of kTile rows. The pack's lo buffer follows 16
// words later, so that a pack row's hi and lo words sit on other banks.
template <int K>
__host__ __device__ constexpr int one_stage() {
  return kThreads * (8 * K + 4);
}
template <int K>
__host__ __device__ constexpr int one_lo_offset() {
  return one_stage<K>() + 16;
}

// A relaxed load at GPU scope (coherent at L2), for a flag other blocks
// set during the launch.
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// p as the compiler must take it from here on: loads through the result
// cannot move above this point (placed after a barrier).
__device__ __forceinline__ const float* after_barrier(const float* p) {
  asm volatile("" : "+l"(p)::"memory");
  return p;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// Issues the copies of the run x[0, len) (len <= K * kTile) into the staged
// s, V floats a copy; floats past len stage as 0.
template <int K, int V>
__device__ __forceinline__ void one_copy_in(const float* __restrict__ x,
                                            int len, float* s) {
  constexpr int kUnits = K * kTile / V / kThreads;
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    const int g = V * (threadIdx.x + j * kThreads);
    const int valid = max(0, min(V, len - g));
    cp_async<V>(s + one_word<K>(g), valid > 0 ? x + g : x, valid);
  }
}

// The thread's per-column sums (hi, lo)[0, K) of its 8 staged rows:
// load_tile's adds, in row order per column, 16 bytes of the rows at a
// time.
template <int K>
__device__ __forceinline__ void one_sums(const float* s, float* hi,
                                         float* lo) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    hi[k] = 0.f;
    lo[k] = 0.f;
  }
  const float* p = s + (8 * K + 4) * threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2 * K; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * i);
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int m = 0; m < 4; ++m)
      ds_add(hi[(4 * i + m) % K], lo[(4 * i + m) % K], e[m], 0.f);
  }
}

// scan_rows on the staged rows from the running (rh, rl)[0, K): each
// result's hi goes back into the element's slot of s, its lo into that of
// s2 (kLoShared) or into lo[4i + m] for the thread's float 4i + m.
template <int K, bool kLoShared>
__device__ __forceinline__ void one_scan(float* s, float* s2, float* rh,
                                         float* rl, float* lo) {
  float* p = s + (8 * K + 4) * threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2 * K; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * i);
    float e[4] = {v.x, v.y, v.z, v.w}, l[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = (4 * i + m) % K;
      ds_add(rh[k], rl[k], e[m], 0.f);
      e[m] = rh[k];
      l[m] = rl[k];
    }
    *reinterpret_cast<float4*>(p + 4 * i) = make_float4(e[0], e[1], e[2], e[3]);
    if constexpr (kLoShared) {
      float* q = s2 + (8 * K + 4) * threadIdx.x;
      *reinterpret_cast<float4*>(q + 4 * i) = make_float4(l[0], l[1], l[2], l[3]);
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m) lo[4 * i + m] = l[m];
    }
  }
}

// Writes the thread's floats lo[0, 8K) back into its slots of s.
template <int K>
__device__ __forceinline__ void one_put_rows(float* s, const float* lo) {
  float* p = s + (8 * K + 4) * threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2 * K; ++i)
    *reinterpret_cast<float4*>(p + 4 * i) =
        make_float4(lo[4 * i], lo[4 * i + 1], lo[4 * i + 2], lo[4 * i + 3]);
}

// Float p of an output run: of the staged run s (kPack false), or of the
// pack's [hi | lo] rows, hi from s and lo from s2.
template <int K, bool kPack>
__device__ __forceinline__ float one_at(const float* s, const float* s2,
                                        int p) {
  if constexpr (kPack) {
    const int r = p / (2 * K), c = p % (2 * K);
    return c < K ? s[one_word<K>(r * K + c)] : s2[one_word<K>(r * K + c - K)];
  } else {
    return s[one_word<K>(p)];
  }
}

// Floats p..p+3 of the output run (p a multiple of 4): one 16-byte read
// where they are four neighbours in one staged buffer.
template <int K, bool kPack>
__device__ __forceinline__ float4 one_at4(const float* s, const float* s2,
                                          int p) {
  if constexpr (!kPack) {
    return *reinterpret_cast<const float4*>(s + one_word<K>(p));
  } else if constexpr (K % 4 == 0) {
    const int r = p / (2 * K), c = p % (2 * K);
    return *reinterpret_cast<const float4*>(
        c < K ? s + one_word<K>(r * K + c) : s2 + one_word<K>(r * K + c - K));
  } else {
    return make_float4(one_at<K, kPack>(s, s2, p),
                       one_at<K, kPack>(s, s2, p + 1),
                       one_at<K, kPack>(s, s2, p + 2),
                       one_at<K, kPack>(s, s2, p + 3));
  }
}

// Writes the output run o[0, len) from the staged buffers, consecutive
// threads on consecutive addresses: 16-byte stores where o is aligned,
// element stores otherwise.
template <int K, bool kPack>
__device__ __forceinline__ void one_store(const float* s, const float* s2,
                                          float* __restrict__ o, int len) {
  constexpr int kFloats = (kPack ? 2 : 1) * K * kTile;
  if (aligned16(o)) {
#pragma unroll
    for (int j = 0; j < kFloats / 4 / kThreads; ++j) {
      const int p = 4 * (threadIdx.x + j * kThreads);
      if (p >= len) continue;
      const float4 v = one_at4<K, kPack>(s, s2, p);
      if (len - p >= 4) {
        *reinterpret_cast<float4*>(o + p) = v;
      } else {
        o[p] = v.x;
        if (len - p > 1) o[p + 1] = v.y;
        if (len - p > 2) o[p + 2] = v.z;
      }
    }
  } else {
#pragma unroll 8
    for (int j = 0; j < kFloats / kThreads; ++j) {
      const int p = threadIdx.x + j * kThreads;
      if (p < len) o[p] = one_at<K, kPack>(s, s2, p);
    }
  }
}

// carry_at's kCarryTotals reduction for the one pass: for tile b, the same
// adds in the same order (thread t adds the totals of tiles t*8..t*8+7
// below b, then a block scan of the thread sums). The totals come from the
// tiles' records rec (2K floats a tile, [hi | lo]), written in this launch
// by other blocks: at L2 (ld.global.cg, never the read-only or L1 path). A
// thread's 8 records are 16K contiguous floats, read 16 bytes a load, a
// few tiles' in flight at once; nothing is read for tiles at or past b (a
// 16-byte load may run into the next record, which nothing adds). rec must
// be 16-byte aligned and come through after_barrier, past the caller's
// acquire and barrier.
template <int K>
__device__ __forceinline__ void carry_published(int b, const float* rec,
                                                float (&run_h)[K],
                                                float (&run_l)[K]) {
  constexpr int kLoad = K <= 2 ? kItems : (K <= 4 ? kItems / 2 : 2);
  constexpr int kWords = kLoad * 2 * K / 4;  // 16-byte loads a batch
#pragma unroll
  for (int k = 0; k < K; ++k) {
    run_h[k] = 0.f;
    run_l[k] = 0.f;
  }
  if (b == 0) return;
  float ch[K], cl[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ch[k] = 0.f;
    cl[k] = 0.f;
  }
  const int u0 = threadIdx.x * kItems;
  const float4* src = reinterpret_cast<const float4*>(rec + u0 * 2 * K);
#pragma unroll
  for (int j0 = 0; j0 < kItems; j0 += kLoad) {
    float r[kLoad * 2 * K];
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const float4 v = u0 + j0 + (4 * q) / (2 * K) < b
                           ? __ldcg(src + j0 * 2 * K / 4 + q)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < kLoad; ++j)
      if (u0 + j0 + j < b)
#pragma unroll
        for (int k = 0; k < K; ++k)
          ds_add(ch[k], cl[k], r[j * 2 * K + k], r[j * 2 * K + K + k]);
  }
  float eh[K], el[K];
  block_scan<K>(ch, cl, eh, el, run_h, run_l);
}

// One launch for nb frames of n rows (2 to kMaxCarryTiles tiles each, K
// columns, row layout), grid nb * tiles. rec: the tiles' records, 16-byte
// aligned, frame z's T records at rec + z * fs.tot; flags: nb * tiles
// zeros (frame z's at z * tiles), then the ticket counter, also 0. out: as
// ds_tile_scan's, frames fs.out apart. Shared memory: the staged tile, and
// with pack its lo buffer. Blocks an SM: as many as that and the registers
// allow (three at K = 4).
template <int K>
__global__ void __launch_bounds__(kThreads, K == 2   ? 5
                                            : K <= 4 ? 3
                                            : K <= 6 ? 2
                                                     : 1)
    ds_tile_onepass(const float* __restrict__ x, long long n, int tiles,
                    float* __restrict__ out, bool pack, float* rec,
                    unsigned* flags, unsigned* next, Frames fs) {
  extern __shared__ __align__(16) float s_one[];
  __shared__ unsigned s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(next, 1u);
  __syncthreads();
  const int z = (int)(s_ticket / (unsigned)tiles);
  const int b = (int)(s_ticket % (unsigned)tiles);
  x += z * fs.in;
  out += z * fs.out;
  rec += z * fs.tot;
  flags += (long long)z * tiles;
  const long long row0 = (long long)b * kTile;
  float* s2 = s_one + one_lo_offset<K>();

  // the tile, read once (rows past the frame stage as 0)
  const int rows = (int)min((long long)kTile, n - row0);
  const float* src = x + row0 * K;
  if (aligned16(src))
    one_copy_in<K, 4>(src, rows * K, s_one);
  else
    one_copy_in<K, 1>(src, rows * K, s_one);
  cp_async_wait_all();
  __syncthreads();
  float hi[K], lo[K], ph[K], pl[K], th[K], tl[K];
  one_sums<K>(s_one, hi, lo);
  block_scan<K>(hi, lo, ph, pl, th, tl);

  // publish the tile's total: its record, then its flag with release
  // semantics (st.release.gpu orders the record before it)
  if (threadIdx.x == 0) {
    float* r = rec + (long long)b * 2 * K;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      r[k] = th[k];
      r[K + k] = tl[k];
    }
    st_release(flags + b, 1u);
  }

  // warp 0 polls the flags of every tile before b, 8 coalesced loads in
  // flight a lane, backing off between polls; then one acquire fence, and
  // the barrier passes it on to the block
  if (threadIdx.x < 32) {
    for (;;) {
      bool ready = true;
      for (int u0 = threadIdx.x; u0 < b; u0 += 8 * 32) {
        unsigned f[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          f[j] = u0 + 32 * j < b ? ld_relaxed(flags + u0 + 32 * j) : 1u;
#pragma unroll
        for (int j = 0; j < 8; ++j) ready = ready && f[j] != 0;
      }
      if (__all_sync(kFull, ready)) break;
      __nanosleep(100);
    }
    fence_acq_rel();
  }
  __syncthreads();
  float run_h[K], run_l[K];
  carry_published<K>(b, after_barrier(rec), run_h, run_l);
#pragma unroll
  for (int k = 0; k < K; ++k) ds_add(run_h[k], run_l[k], ph[k], pl[k]);

  if (pack) {
    one_scan<K, true>(s_one, s2, run_h, run_l, nullptr);
    __syncthreads();
    if (b == 0 && threadIdx.x < 2 * K) out[threadIdx.x] = 0.f;
    one_store<K, true>(s_one, s2, out + 2 * K + row0 * 2 * K, rows * 2 * K);
    return;
  }
  // hi runs from the staged tile, then lo (held in registers meanwhile)
  // through the same slots
  float lk[8 * K];
  one_scan<K, false>(s_one, nullptr, run_h, run_l, lk);
  __syncthreads();
  one_store<K, false>(s_one, nullptr, out + row0 * K, rows * K);
  __syncthreads();
  one_put_rows<K>(s_one, lk);
  __syncthreads();
  one_store<K, false>(s_one, nullptr, out + n * K + row0 * K, rows * K);
}

// -- The sharded entry: a device's shards, one launch a pass ------------------
//
// A device's part of a sharded scan is a table of segments (Seg): its own
// shards' rows, and the first rows of another device's shards that its tiles
// run into (received into buffers, their pack rows written to buffers that
// the caller returns). Tile t of the whole is scanned on the device of the
// shard holding its first row; the table lists the device's owned tiles in
// global order (local index i, Seg::local0), each segment its own run.
//
// Pass 1 (ds_shard_total, ds_shard_wide_total): a block a tile, the single
// entry's totals pass (stage_in, the thread's 8 rows, block_scan), writing
// the tile's total at its global index t into the device's totals buffer
// (the whole scan's scratch layout: hi (T, K), then lo). The caller copies
// the other devices' totals in; past kMaxCarryTiles tiles their scan runs
// once on the device (scan_level / wide_level on the totals, as the whole
// scan's).
//
// Pass 2 for K <= 8 (ds_shard_scan): persistent blocks, as many as the SMs
// hold (two an SM up to K = 4), each taking a fixed run of consecutive work
// items (frame-major, then the device's tiles in global order). Every
// tile's carry is known at launch (the totals are all there), so nothing
// waits on another block. A block stages the next tile with cp.async (16
// bytes a copy where the rows lie at an aligned address, 4 otherwise;
// one_copy_in, coalesced, into one_word's padded layout) while it scans
// the current one, then writes the tile's pack rows from shared memory in
// coalesced 16-byte streaming stores (after 2 element stores where the run
// is 8 bytes off 16: odd K), which the memory system drains while the next
// tile is scanned. The carry is carry_at's: thread t adds the totals of tiles
// 8t .. 8t + 7 below the tile in order, then a block scan of the thread
// sums; a block keeps its threads' sums from one tile to the next and adds
// only the totals it has not added yet, in the same order, so only the
// block scan is redone a tile and the totals are read about once a block.
// The leading row of a co-resident shard is written by the block holding
// the row before it; tile 0 writes the zero rows. A boundary tile whose
// rows lie in several segments is staged and written element by element.
// Numerics: the single entry's adds in the single entry's order
// (load_tile's sums, block_scan, carry_at, scan_rows) with __fadd_rn,
// --fmad=false and no atomic, so every shard's pack is bitwise its rows of
// the single (batched) entry's pack on the whole. Why not bulk copies: a
// whole tile's cp.async.bulk cannot leave the pad words that keep the
// threads' 16-byte reads off each other's banks, and a version that moved
// each thread's 8 rows in and its 8 pack rows out by bulk copies of their
// own (512 of 128-256 bytes a tile, an mbarrier a stage) took 0.087 ms for
// this pass at (2^21, 4), no faster than the single entry's (PERF.md §6).
//
// K > 8 keeps the wide path's column-block bodies (ds_wide_total /
// ds_wide_scan) on the device's table: a block a (tile, column block), a
// boundary tile staged and written element by element.
//
// Bound on the card, per device: bytes, 4nK read and 8nK written for its n
// rows (plus the received halo rows twice and the (T, K) totals). At (2^21,
// 4) over sp=4 on one card: 33.6 MB read, 67.1 MB written, 0.0300 ms at
// an H100's 3.35 TB/s. What it leaves (H100 80GB HBM3, 700 W; PERF.md §6):
// the two passes take about 0.019 + 0.052 ms there, 2.4x the bound; pass 1
// reads the input a second time (0.011 ms for a plain read of those
// bytes), and pass 2 runs at about two thirds of the card's rate for a
// read and write of its 100.7 MB.

constexpr int kMaxSegs = 32;  // segments a device's table holds

// Rows [start, start + rows) of the whole on one device: in its input
// (frames in_fs floats apart, row start first), out its pack rows (row
// start's [hi | lo] first, frames out_fs apart), lead the leading pack row
// that this device writes (the row before start), or null. Owned tiles
// [tile0, tile0 + tiles), local indices from local0.
struct Seg {
  long long start, rows, in_fs, out_fs, tile0, tiles, local0;
  const float* in;
  float* out;
  float* lead;
};

// A device's table: n rows and `tiles` tiles of the whole, `local` of them
// owned here.
struct Table {
  long long n, tiles, local;
  int nseg;
  Seg seg[kMaxSegs];
};

// The segment owning the device's local tile i.
__device__ __forceinline__ int owner_seg(const Table& tab, long long i) {
  int s = 0;
  while (s < tab.nseg - 1 &&
         (tab.seg[s].tiles == 0 || i >= tab.seg[s].local0 + tab.seg[s].tiles))
    ++s;
  return s;
}

// The segment holding global row r, searched from segment s on (segments
// in row order; every row of an owned tile lies in one).
__device__ __forceinline__ int seg_of(const Table& tab, long long r, int s) {
  while (s < tab.nseg - 1 &&
         (tab.seg[s].rows == 0 || r >= tab.seg[s].start + tab.seg[s].rows))
    ++s;
  return s;
}

// stage_in for a tile whose rows [r0, r0 + R) of frame z lie in more than
// one segment (from segment s on): element loads, positions past R hold 0.
template <int K>
__device__ void stage_rows(const Table& tab, int s, long long z, long long r0,
                           int R, float* st) {
  for (int q = threadIdx.x; q < K * kTile; q += kThreads) {
    const int r = q / K;
    float v = 0.f;
    if (r < R) {
      const Seg& g = tab.seg[seg_of(tab, r0 + r, s)];
      v = g.in[z * g.in_fs + (r0 + r - g.start) * K + q % K];
    }
    st[pad(q)] = v;
  }
}

// Pass 1, K <= 8: block (i, z) takes the device's local tile i of frame z
// and writes its total at its global index b: tot + z * tot_fs + b * K (hi),
// T * K floats later (lo). The adds are ds_tile_total's.
template <int K>
__global__ void __launch_bounds__(kThreads)
    ds_shard_total(const __grid_constant__ Table tab, float* __restrict__ tot,
                   long long tot_fs) {
  extern __shared__ float s_tile[];
  const long long z = blockIdx.z;
  const int s = owner_seg(tab, blockIdx.x);
  const Seg& g = tab.seg[s];
  const long long b = g.tile0 + (blockIdx.x - g.local0);
  const long long r0 = b * kTile;
  const int R = (int)min((long long)kTile, tab.n - r0);
  if (r0 + R <= g.start + g.rows)
    stage_in<K>(g.in + z * g.in_fs, true, 1, r0 - g.start, R, s_tile);
  else
    stage_rows<K>(tab, s, z, r0, R, s_tile);
  __syncthreads();
  float xh[kItems][K], hi[K], lo[K], ph[K], pl[K], th[K], tl[K];
  read_rows<K>(s_tile, true, xh);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    hi[k] = 0.f;
    lo[k] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) ds_add(hi[k], lo[k], xh[j][k], 0.f);
  block_scan<K>(hi, lo, ph, pl, th, tl);
  if (threadIdx.x == 0) {
    float* t = tot + z * tot_fs;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      t[b * K + k] = th[k];
      t[tab.tiles * K + b * K + k] = tl[k];
    }
  }
}

// cp.async's groups: the thread's copies issued so far as one group; wait
// until all but the newest n groups have landed.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory of a pass-2 block: two staged tiles in one_word's layout
// (a thread's 8 rows, then 4 pad words), the next tile's copies landing in
// one while the other is scanned, then the pack's lo buffer, 16 floats
// apart (one_lo_offset's bank shift). 110.7 KB at K = 4: two blocks an SM.
template <int K>
__host__ __device__ constexpr int shard_stage() {
  return one_stage<K>() + 16;
}
template <int K>
__host__ __device__ constexpr int shard_scan_floats() {
  return 3 * shard_stage<K>();
}

// Issues (every thread) the copies of work item w's tile (frame w / local,
// local tile w % local) into the staged s: cp.async of 16 bytes where its
// rows lie in one segment at an aligned address, of 4 bytes where they lie
// off 16 bytes (rows past the matrix stage as 0); a boundary tile whose
// rows lie in several segments is loaded element by element.
template <int K>
__device__ __forceinline__ void shard_issue(const Table& tab, long long w,
                                            float* s) {
  const long long z = w / tab.local, i = w % tab.local;
  const int so = owner_seg(tab, i);
  const Seg& g = tab.seg[so];
  const long long r0 = (g.tile0 + (i - g.local0)) * kTile;
  const int R = (int)min((long long)kTile, tab.n - r0);
  if (r0 + R <= g.start + g.rows) {
    const float* src = g.in + z * g.in_fs + (r0 - g.start) * K;
    if (aligned16(src))
      one_copy_in<K, 4>(src, R * K, s);
    else
      one_copy_in<K, 1>(src, R * K, s);
    return;
  }
  for (int q = threadIdx.x; q < K * kTile; q += kThreads) {
    const int r = q / K;
    float v = 0.f;
    if (r < R) {
      const Seg& h = tab.seg[seg_of(tab, r0 + r, so)];
      v = h.in[z * h.in_fs + (r0 + r - h.start) * K + q % K];
    }
    s[one_word<K>(q)] = v;
  }
}

// Writes the tile's pack floats [0, len) (hi from s, lo from s2, as
// one_at) to o[0, len), consecutive threads on consecutive addresses:
// 16-byte streaming stores (st.global.cs: the pack is not read again here,
// and leaving L2 to the input keeps more of it there for the next call's
// pass 1) where o is aligned, after 2 element stores where it is 8 bytes
// off (odd K: a pack row is 2K floats after the leading row), element
// stores otherwise.
template <int K>
__device__ __forceinline__ void shard_store(const float* s, const float* s2,
                                            float* __restrict__ o, int len) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(o);
  if ((a & 7) != 0) {
    for (int p = threadIdx.x; p < len; p += kThreads)
      o[p] = one_at<K, true>(s, s2, p);
    return;
  }
  const int head = (a & 15) ? 2 : 0;
  if ((int)threadIdx.x < min(head, len))
    o[threadIdx.x] = one_at<K, true>(s, s2, threadIdx.x);
  constexpr int kFloats = 2 * K * kTile;
#pragma unroll
  for (int j = 0; j < kFloats / 4 / kThreads; ++j) {
    const int p = head + 4 * (threadIdx.x + j * kThreads);
    if (p >= len) continue;
    const float4 v =
        head == 0 ? one_at4<K, true>(s, s2, p)
                  : make_float4(one_at<K, true>(s, s2, p),
                                one_at<K, true>(s, s2, p + 1),
                                one_at<K, true>(s, s2, p + 2),
                                one_at<K, true>(s, s2, p + 3));
    if (len - p >= 4) {
      __stcs(reinterpret_cast<float4*>(o + p), v);
    } else {
      o[p] = v.x;
      if (len - p > 1) o[p + 1] = v.y;
      if (len - p > 2) o[p + 2] = v.z;
    }
  }
}

// Pass 2, K <= 8: nb frames of the device's tiles, persistent blocks (see
// above). carry: kCarryTotals: carry_hi / carry_lo the (T, K) totals,
// frames tot_fs apart; kCarryScanned: their inclusive scan; kCarryNone: a
// single tile. Two blocks an SM up to K = 4 (<= 128 registers).
template <int K>
__global__ void __launch_bounds__(kThreads, K <= 4 ? 2 : 1)
    ds_shard_scan(const __grid_constant__ Table tab,
                  const float* __restrict__ carry_hi,
                  const float* __restrict__ carry_lo, int carry,
                  long long tot_fs, long long nb) {
  extern __shared__ __align__(16) float s_sh[];
  const long long work = nb * tab.local;
  const long long w0 = work * blockIdx.x / gridDim.x;
  const long long w1 = work * (blockIdx.x + 1) / gridDim.x;
  if (w0 >= w1) return;
  float* const s2 = s_sh + 2 * shard_stage<K>();
  shard_issue<K>(tab, w0, s_sh);
  cp_async_commit();
  // the thread's running sum of the totals of tiles [8t, 8t + 8) below
  // `done` in frame cz (carry_at's adds, kept from tile to tile)
  float ch[K], cl[K];
  long long cz = -1, done = 0;
  for (long long w = w0; w < w1; ++w) {
    const int it = (int)(w - w0);
    float* const s = s_sh + (it & 1) * shard_stage<K>();
    if (w + 1 < w1) {
      shard_issue<K>(tab, w + 1, s_sh + ((it + 1) & 1) * shard_stage<K>());
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const long long z = w / tab.local, i = w % tab.local;
    const int so = owner_seg(tab, i);
    const Seg& g = tab.seg[so];
    const long long b = g.tile0 + (i - g.local0);
    const long long r0 = b * kTile;
    const int R = (int)min((long long)kTile, tab.n - r0);

    // the thread's sums and its exclusive prefix in the tile
    float hi[K], lo[K], ph[K], pl[K], th[K], tl[K];
    one_sums<K>(s, hi, lo);
    block_scan<K>(hi, lo, ph, pl, th, tl);

    // the carry in front of tile b
    float rh[K], rl[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      rh[k] = 0.f;
      rl[k] = 0.f;
    }
    if (carry == kCarryTotals) {
      if (z != cz) {
        cz = z;
        done = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          ch[k] = 0.f;
          cl[k] = 0.f;
        }
      }
      const float* th_ = carry_hi + z * tot_fs;
      const float* tl_ = carry_lo + z * tot_fs;
      const long long u1 = min((long long)kItems * threadIdx.x + kItems, b);
      const long long u0 = max((long long)kItems * threadIdx.x, done);
      for (long long u = u0; u < u1; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k)
          ds_add(ch[k], cl[k], th_[u * K + k], tl_[u * K + k]);
      done = b;
      if (b > 0) {
        float sh[K], sl[K], eh[K], el[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          sh[k] = ch[k];
          sl[k] = cl[k];
        }
        block_scan<K>(sh, sl, eh, el, rh, rl);
      }
    } else if (carry == kCarryScanned && b > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        rh[k] = carry_hi[z * tot_fs + (b - 1) * K + k];
        rl[k] = carry_lo[z * tot_fs + (b - 1) * K + k];
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) ds_add(rh[k], rl[k], ph[k], pl[k]);

    // the rows: hi back into the staged tile, lo into s2
    one_scan<K, true>(s, s2, rh, rl, nullptr);
    __syncthreads();
    if (r0 + R <= g.start + g.rows) {
      shard_store<K>(s, s2, g.out + z * g.out_fs + (r0 - g.start) * 2 * K,
                     R * 2 * K);
    } else {
      for (int p = threadIdx.x; p < R * 2 * K; p += kThreads) {
        const int r = p / (2 * K);
        const Seg& h = tab.seg[seg_of(tab, r0 + r, so)];
        h.out[z * h.out_fs + (r0 + r - h.start) * 2 * K + p % (2 * K)] =
            one_at<K, true>(s, s2, p);
      }
    }
    // leading rows of co-resident shards (the row before their first),
    // and on tile 0 the zero rows
    if (threadIdx.x < 2 * K) {
      for (int q = 0; q < tab.nseg; ++q) {
        const Seg& h = tab.seg[q];
        if (h.lead == nullptr) continue;
        const long long lr = h.start - 1 - r0;
        if (lr >= 0 && lr < R)
          h.lead[z * h.out_fs + threadIdx.x] =
              one_at<K, true>(s, s2, (int)lr * 2 * K + threadIdx.x);
        else if (h.start == 0 && b == 0)
          h.lead[z * h.out_fs + threadIdx.x] = 0.f;
      }
    }
    __syncthreads();  // s and s2 read before the next copies and scan
  }
}

// stage_rows for the wide path: rows [r0, r0 + R), columns [c0, c0 + kv)
// of frame z into the staged column block (wide_word), element by element;
// rows past R and columns past kv as 0.
__device__ void wide_stage_rows(const Table& tab, int s, long long z,
                                long long r0, int R, int ncol, int c0, int kv,
                                float* st) {
  for (int e = threadIdx.x; e < kWide * kTile; e += kThreads) {
    const int r = e / kWide, c = e % kWide;
    float v = 0.f;
    if (r < R && c < kv) {
      const Seg& g = tab.seg[seg_of(tab, r0 + r, s)];
      v = g.in[z * g.in_fs + (r0 + r - g.start) * ncol + c0 + c];
    }
    st[wide_word(true, r, c)] = v;
  }
}

// The wide block of blockIdx.x on a device's table: its owner segment s,
// global tile b (rows r0 ..), R rows, first column c0, kv columns.
struct ShardWide {
  long long b, r0;
  int s, R, c0, kv;
};

__device__ __forceinline__ ShardWide shard_wide(const Table& tab, int ncol) {
  const unsigned ncb = (ncol + kWide - 1) / kWide;
  const long long i = blockIdx.x / ncb;
  ShardWide w;
  w.s = owner_seg(tab, i);
  w.b = tab.seg[w.s].tile0 + (i - tab.seg[w.s].local0);
  w.r0 = w.b * kTile;
  w.R = (int)min((long long)kTile, tab.n - w.r0);
  w.c0 = (int)(blockIdx.x % ncb) * kWide;
  w.kv = min(kWide, ncol - w.c0);
  return w;
}

// Whether the block's tile lies in its owner segment.
__device__ __forceinline__ bool wide_whole(const Table& tab,
                                           const ShardWide& w) {
  return w.r0 + w.R <= tab.seg[w.s].start + tab.seg[w.s].rows;
}

// Issues (whole) or makes (a boundary tile) the staged column block.
__device__ __forceinline__ void shard_wide_in(const Table& tab,
                                              const ShardWide& w, long long z,
                                              int ncol, bool whole, float* s) {
  const Seg& g = tab.seg[w.s];
  if (whole)
    wide_stage_in(g.in + z * g.in_fs + (w.r0 - g.start) * ncol + w.c0, true,
                  ncol, 1, w.R, w.kv, s);
  else
    wide_stage_rows(tab, w.s, z, w.r0, w.R, ncol, w.c0, w.kv, s);
}

// Writes the staged column block (hi, or with off = ncol lo) to the pack
// rows of the segments holding the tile's rows, and to each leading row
// whose row before lies in the tile.
__device__ void shard_wide_out(const Table& tab, const ShardWide& w,
                               long long z, int ncol, int off, bool whole,
                               const float* s) {
  const Seg& g = tab.seg[w.s];
  if (whole) {
    float* o = g.out + z * g.out_fs + (w.r0 - g.start) * 2 * ncol + off;
    wide_stage_out(s, true, o + w.c0, 2 * ncol, 1, w.R, w.kv);
  } else {
    for (int e = threadIdx.x; e < w.R * w.kv; e += kThreads) {
      const int r = e / w.kv, c = e % w.kv;
      const Seg& h = tab.seg[seg_of(tab, w.r0 + r, w.s)];
      h.out[z * h.out_fs + (w.r0 + r - h.start) * 2 * ncol + off + w.c0 + c] =
          s[wide_word(true, r, c)];
    }
  }
  if (threadIdx.x < w.kv) {
    for (int q = 0; q < tab.nseg; ++q) {
      const Seg& h = tab.seg[q];
      const long long lr = h.start - 1 - w.r0;
      if (h.lead != nullptr && lr >= 0 && lr < w.R)
        h.lead[z * h.out_fs + off + w.c0 + threadIdx.x] =
            s[wide_word(true, (int)lr, threadIdx.x)];
    }
  }
}

// Pass 1 for K > 8: ds_wide_total's body on the device's table, block (i *
// ncb + column block, z); totals at tot + z * tot_fs, (T, ncol) hi then lo.
__global__ void __launch_bounds__(kThreads, 3)
    ds_shard_wide_total(const __grid_constant__ Table tab, int ncol,
                        float* __restrict__ tot, long long tot_fs) {
  extern __shared__ __align__(16) float s_wide[];
  const long long z = blockIdx.z;
  const ShardWide w = shard_wide(tab, ncol);
  shard_wide_in(tab, w, z, ncol, wide_whole(tab, w), s_wide);
  cp_async_wait_all();
  __syncthreads();
  float hi[kWide], lo[kWide], ph[kWide], pl[kWide], th[kWide], tl[kWide];
  wide_row_sums<false>(s_wide, nullptr, true, hi, lo);
  block_scan<kWide>(hi, lo, ph, pl, th, tl);
  if (threadIdx.x == 0) {
    float* t = tot + z * tot_fs;
#pragma unroll
    for (int k = 0; k < kWide; ++k)
      if (k < w.kv) {
        t[w.b * ncol + w.c0 + k] = th[k];
        t[tab.tiles * ncol + w.b * ncol + w.c0 + k] = tl[k];
      }
  }
}

// Pass 2 for K > 8: ds_wide_scan's body on the device's table; carry as in
// ds_shard_scan over (T, ncol) totals.
__global__ void __launch_bounds__(kThreads, 2)
    ds_shard_wide_scan(const __grid_constant__ Table tab, int ncol,
                       const float* __restrict__ carry_hi,
                       const float* __restrict__ carry_lo, int carry,
                       long long tot_fs) {
  extern __shared__ __align__(16) float s_wide[];
  const long long z = blockIdx.z;
  const ShardWide w = shard_wide(tab, ncol);
  const bool whole = wide_whole(tab, w);
  if (whole) shard_wide_in(tab, w, z, ncol, true, s_wide);
  float run_h[kWide], run_l[kWide];
  carry_at<kWide>((int)w.b, carry, carry_hi ? carry_hi + z * tot_fs : nullptr,
                  carry_lo ? carry_lo + z * tot_fs : nullptr, ncol, w.c0, w.kv,
                  run_h, run_l);
  if (whole)
    cp_async_wait_all();
  else
    shard_wide_in(tab, w, z, ncol, false, s_wide);
  __syncthreads();
  {
    float hi[kWide], lo[kWide], ph[kWide], pl[kWide], th[kWide], tl[kWide];
    wide_row_sums<false>(s_wide, nullptr, true, hi, lo);
    block_scan<kWide>(hi, lo, ph, pl, th, tl);
#pragma unroll
    for (int k = 0; k < kWide; ++k) ds_add(run_h[k], run_l[k], ph[k], pl[k]);
  }
  if (w.b == 0 && threadIdx.x < w.kv) {
    for (int q = 0; q < tab.nseg; ++q) {
      const Seg& h = tab.seg[q];
      if (h.lead != nullptr && h.start == 0) {
        h.lead[z * h.out_fs + w.c0 + threadIdx.x] = 0.f;
        h.lead[z * h.out_fs + ncol + w.c0 + threadIdx.x] = 0.f;
      }
    }
  }
  float lo_out[kItems][kWide];
  wide_scan_rows<false>(s_wide, nullptr, true, run_h, run_l, lo_out);
  __syncthreads();
  shard_wide_out(tab, w, z, ncol, 0, whole, s_wide);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    store_line(s_wide, wide_line(true, i), lo_out[i]);
  __syncthreads();
  shard_wide_out(tab, w, z, ncol, ncol, whole, s_wide);
}

// Whether the current device still lacks the opt-in that `done` records,
// one bit a device: cudaFuncSetAttribute binds a kernel's attributes on the
// current device only, so each device opts in on its first launch there.
// The caller sets the attributes, then mark_raised. Devices past the 64
// bits opt in on every launch.
bool needs_raise(const std::atomic<uint64_t>& done, int* dev) {
  if (cudaGetDevice(dev) != cudaSuccess) return true;
  return *dev >= 64 || !((done.load() >> *dev) & 1);
}

void mark_raised(std::atomic<uint64_t>& done, int dev) {
  if (dev >= 0 && dev < 64) done.fetch_or(uint64_t{1} << dev);
}

template <int K, bool kPair, bool kBatch>
size_t stage_bytes() {
  const size_t bytes = sizeof(float) * stage_floats(K);
  static std::atomic<uint64_t> raised{0};  // above 48 KB needs the opt-in
  int dev = -1;
  if (bytes > 48 * 1024 && needs_raise(raised, &dev)) {
    cudaFuncSetAttribute(ds_tile_total<K, kPair, kBatch>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    cudaFuncSetAttribute(ds_tile_scan<K, kPair, kBatch>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    mark_raised(raised, dev);
  }
  return bytes;
}

// Floats of scratch that pass 2 needs for a matrix of t tiles of k columns
// (one frame): the tile totals hi, lo, and beyond kMaxCarryTiles their
// scan and the next level's scratch.
long long scratch_tiles(long long t, int k) {
  if (t <= 1) return 0;
  if (t <= kMaxCarryTiles) return 2 * t * k;
  return 4 * t * k + scratch_tiles((t + kTile - 1) / kTile, k);
}

// Floats of scratch that scan_level needs for n rows of k columns (one
// frame).
long long scratch_need(long long n, int k) {
  return scratch_tiles((n + kTile - 1) / kTile, k);
}

// Whether the batched entry scans frames of t tiles of k columns in one
// pass (ds_tile_onepass); otherwise scan_level's or wide_level's passes.
// One column stays on the two passes: its stack (16 MiB at the dataset
// path's (4, 2^20, 1) weight scans) is read again from L2, and a tile of
// one column carries too few bytes to hide the one pass's chain of round
// trips.
bool one_pass(long long t, int k) {
  return k >= 2 && k <= kWide && t >= 2 && t <= kMaxCarryTiles;
}

// Floats of one frame's one-pass records: 2k a tile, rounded up to a
// multiple of 4 so that every frame's records stay 16-byte aligned.
long long one_frame_floats(long long t, int k) { return (t * 2 * k + 3) / 4 * 4; }

// Floats of scratch the batched entry needs for b frames: for one pass, a
// frame's records (after up to 3 floats that align them to 16 bytes), then
// a flag a tile and the ticket counter (32-bit words); otherwise
// scratch_need a frame.
long long batched_scratch_need(long long b, long long n, int k) {
  const long long t = (n + kTile - 1) / kTile;
  if (one_pass(t, k)) return b * one_frame_floats(t, k) + 3 + b * t + 1;
  return b * scratch_need(n, k);
}

// Shared memory of a one-pass block: its staged tile, and with pack its lo
// buffer. The carveout asks for the SM's whole 228 KB as shared
// memory. The opt-in is made for the larger size.
template <int K>
size_t one_stage_bytes(bool pack) {
  const size_t whole =
      sizeof(float) * (one_lo_offset<K>() + one_stage<K>());
  static std::atomic<uint64_t> raised{0};
  int dev = -1;
  if (needs_raise(raised, &dev)) {
    cudaFuncSetAttribute(ds_tile_onepass<K>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)whole);
    cudaFuncSetAttribute(ds_tile_onepass<K>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    mark_raised(raised, dev);
  }
  return pack ? whole : sizeof(float) * one_stage<K>();
}

// The one-pass scan of nb frames of n rows (t tiles each): the flags and
// the counter zeroed on the stream, then one launch, a block a tile.
template <int K>
void one_pass_scan(const float* x, long long n, long long t, bool pack,
                   float* out, float* rec, unsigned* flags, cudaStream_t st,
                   int nb, Frames fs) {
  const size_t smem = one_stage_bytes<K>(pack);
  const long long blocks = nb * t;
  if (cudaMemsetAsync(flags, 0, sizeof(unsigned) * (nb * t + 1), st) !=
      cudaSuccess)
    return;
  ds_tile_onepass<K><<<(unsigned)blocks, kThreads, smem, st>>>(
      x, n, (int)t, out, pack, rec, flags, flags + nb * t, fs);
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
  static std::atomic<uint64_t> raised{0};
  int dev = -1;
  if (needs_raise(raised, &dev)) {
    for (const void* f : {(const void*)ds_wide_total<kPair, kBatch>,
                          (const void*)ds_wide_scan<kPair, kBatch>}) {
      cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
      cudaFuncSetAttribute(f, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
    }
    mark_raised(raised, dev);
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


// Shared memory of the sharded entry's blocks, the opt-in made on each
// device's first launch there.
template <int K>
size_t shard_total_bytes() {
  const size_t bytes = sizeof(float) * stage_floats(K);
  static std::atomic<uint64_t> raised{0};
  int dev = -1;
  if (bytes > 48 * 1024 && needs_raise(raised, &dev)) {
    cudaFuncSetAttribute(ds_shard_total<K>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    mark_raised(raised, dev);
  }
  return bytes;
}

template <int K>
size_t shard_scan_bytes() {
  const size_t bytes = sizeof(float) * shard_scan_floats<K>();
  static std::atomic<uint64_t> raised{0};
  int dev = -1;
  if (needs_raise(raised, &dev)) {
    cudaFuncSetAttribute(ds_shard_scan<K>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    cudaFuncSetAttribute(ds_shard_scan<K>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    mark_raised(raised, dev);
  }
  return bytes;
}

size_t shard_wide_bytes() {
  const size_t bytes = sizeof(float) * kWideStage;
  static std::atomic<uint64_t> raised{0};
  int dev = -1;
  if (needs_raise(raised, &dev)) {
    for (const void* f : {(const void*)ds_shard_wide_total,
                          (const void*)ds_shard_wide_scan}) {
      cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
      cudaFuncSetAttribute(f, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
    }
    mark_raised(raised, dev);
  }
  return bytes;
}

// A persistent kernel's grid on the current device: as many blocks of
// `kernel` as its SMs hold at once (kept per kernel and device, up to 64).
template <class F>
long long persistent_grid(F kernel, size_t smem, std::atomic<int> (&grid)[64]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = 64;
  if (dev < 64 && grid[dev].load() > 0) return grid[dev].load();
  int sms = 0, per = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                         dev < 64 ? dev : 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, smem);
  const int g = max(1, sms) * max(1, per);
  if (dev < 64) grid[dev].store(g);
  return g;
}

// The carries' source for pass 2 over the whole's T tiles, frames fs apart
// in the scratch (the totals at its front): none for one tile, the totals
// up to kMaxCarryTiles, else their inclusive scan, made here once for the
// device as the whole scan makes it.
struct Carries {
  const float *hi, *lo;
  int carry;
};

template <int K>
Carries shard_carries(float* scratch, long long T, int ncol, long long nb,
                      long long fs, cudaStream_t st) {
  if (T <= 1) return {nullptr, nullptr, kCarryNone};
  float* tot_hi = scratch;
  float* tot_lo = scratch + T * ncol;
  if (T <= kMaxCarryTiles) return {tot_hi, tot_lo, kCarryTotals};
  float* inc = tot_lo + T * ncol;
  if constexpr (K > kWide)
    wide_level<true, true>(tot_hi, tot_lo, T, ncol, ncol, 1, inc,
                           inc + T * ncol, ncol, 1, nullptr,
                           inc + 2 * T * ncol, st, (int)nb, Frames{fs, fs, fs});
  else
    scan_level<K, true, true>(tot_hi, tot_lo, T, 1, inc, false,
                              inc + 2 * T * ncol, st, (int)nb,
                              Frames{fs, fs, fs});
  return {inc, inc + T * ncol, kCarryScanned};
}

// One pass of the sharded entry on a device's table: pass 1 (totals into
// the scratch) or pass 2 (the carries, then the scan).
template <int K>
void shard_pass(int pass, const Table& tab, long long nb, float* scratch,
                long long fs, cudaStream_t st) {
  if (pass == 1) {
    const dim3 grid((unsigned)tab.local, 1, (unsigned)nb);
    const size_t smem = shard_total_bytes<K>();
    ds_shard_total<K><<<grid, kThreads, smem, st>>>(tab, scratch, fs);
    return;
  }
  static std::atomic<int> grids[64];
  const Carries c = shard_carries<K>(scratch, tab.tiles, K, nb, fs, st);
  const size_t smem = shard_scan_bytes<K>();
  const long long grid =
      min(nb * tab.local, persistent_grid(ds_shard_scan<K>, smem, grids));
  ds_shard_scan<K><<<(unsigned)grid, kThreads, smem, st>>>(tab, c.hi, c.lo,
                                                           c.carry, fs, nb);
}

void shard_wide_pass(int pass, const Table& tab, int ncol, long long nb,
                     float* scratch, long long fs, cudaStream_t st) {
  const size_t smem = shard_wide_bytes();
  const dim3 grid((unsigned)(tab.local * ((ncol + kWide - 1) / kWide)), 1,
                  (unsigned)nb);
  if (pass == 1) {
    ds_shard_wide_total<<<grid, kThreads, smem, st>>>(tab, ncol, scratch, fs);
    return;
  }
  const Carries c =
      shard_carries<kWide + 1>(scratch, tab.tiles, ncol, nb, fs, st);
  ds_shard_wide_scan<<<grid, kThreads, smem, st>>>(tab, ncol, c.hi, c.lo,
                                                    c.carry, fs);
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
// layout, -3 for too little scratch. `stream` and x belong to the current
// device, on which the kernels' shared-memory opt-in is made.
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
// writes 134.2 MB, ~0.060 ms at 3.35 TB/s. With 2 to 8 columns and 2 to
// 2048 tiles a frame, one launch (ds_tile_onepass, after a memset of its
// flags) reads each tile once from device memory and writes it once: 201
// MB at that pack, against the two passes' 268 MB. Other shapes take the
// single entry's passes with the frame on blockIdx.z, B times its blocks.
//
// x: b contiguous (n, k) row-layout frames. Without pack, out gets frame
// z's hi at out + 2 * z * n * k and its lo n * k floats after it (a
// (b, 2, n, k) block); with pack, the (b, n + 1, 2k) stack of packs, each
// a zero row, then rows [hi | lo]. scratch holds scratch_floats floats, of
// which each frame takes scratch_need(n, k) and one pass's flags and
// counter the rest (batched_scratch_need). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launches, or
// without launching -1 for k < 1, -3 for too little scratch, -4 for a
// frame count outside [1, 65535].
int ds_cumsum_batched_f32(const float* x, long long b, long long n, int k,
                          int pack, float* out, float* scratch,
                          long long scratch_floats, void* stream) {
  if (k < 1) return -1;
  if (b < 1 || b > 65535) return -4;
  if (scratch_floats < batched_scratch_need(b, n, k)) return -3;
  const long long need = scratch_need(n, k);
  const long long t = (n + kTile - 1) / kTile;
  const long long out_fs = pack ? (n + 1) * 2 * k : 2 * n * k;
  const Frames fs{n * k, need, out_fs};
  const auto st = static_cast<cudaStream_t>(stream);
  if (!one_pass(t, k))
    return launch_scan<true>(x, n, k, k, 1, pack != 0, out, scratch, st,
                             (int)b, fs);
  float* rec = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(scratch) + 15) & ~uintptr_t{15});
  unsigned* flags =
      reinterpret_cast<unsigned*>(rec + b * one_frame_floats(t, k));
  const Frames ofs{n * k, one_frame_floats(t, k), out_fs};
#define DS_ONE_PASS_CASE(K)                                              \
  case K:                                                                \
    one_pass_scan<K>(x, n, t, pack != 0, out, rec, flags, st, (int)b, \
                     ofs);                                               \
    break;
  switch (k) {
    DS_ONE_PASS_CASE(2)
    DS_ONE_PASS_CASE(3)
    DS_ONE_PASS_CASE(4)
    DS_ONE_PASS_CASE(5)
    DS_ONE_PASS_CASE(6)
    DS_ONE_PASS_CASE(7)
    DS_ONE_PASS_CASE(8)
  }
#undef DS_ONE_PASS_CASE
  return static_cast<int>(cudaGetLastError());
}

// The sharded entry (see "The sharded entry" above): one pass on one
// device's table, for b frames of k columns. meta: 8 int64 a segment
// (start, rows, in_fs, out_fs, tile0, tiles, local0, lead), ptrs: 3
// pointers a segment (in, out, lead, null where the device does not write
// the leading row); n rows and `tiles` tiles of the whole, `local` owned
// here. Pass 1 writes the owned tiles' totals into scratch (scratch_fs >=
// scratch_tiles(tiles, k) floats a frame, the totals at its front); pass 2,
// once every total is there, scans the owned tiles (first scanning the
// totals past kMaxCarryTiles tiles). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launches (none for
// a device without owned tiles, nor pass 1 of a single tile), or without
// launching -1 for k < 1, -2 for a pass other than 1 or 2, -3 for too
// little scratch, -4 for a frame count outside [1, 65535], -5 for a table
// outside [1, kMaxSegs] segments.
int ds_shard_pass_f32(int pass, const long long* meta, void* const* ptrs,
                      int nseg, long long n, long long tiles, long long local,
                      int k, long long b, float* scratch,
                      long long scratch_fs, void* stream) {
  if (k < 1) return -1;
  if (pass != 1 && pass != 2) return -2;
  if (b < 1 || b > 65535) return -4;
  if (nseg < 1 || nseg > kMaxSegs) return -5;
  if (local > 0 && scratch_fs < scratch_tiles(tiles, k)) return -3;
  if (local == 0 || (pass == 1 && tiles <= 1)) return 0;
  Table tab{n, tiles, local, nseg, {}};
  for (int s = 0; s < nseg; ++s) {
    const long long* m = meta + 8 * s;
    tab.seg[s] = Seg{m[0], m[1], m[2], m[3], m[4], m[5], m[6],
                     static_cast<const float*>(ptrs[3 * s]),
                     static_cast<float*>(ptrs[3 * s + 1]),
                     static_cast<float*>(ptrs[3 * s + 2])};
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (k > kWide) {
    shard_wide_pass(pass, tab, k, b, scratch, scratch_fs, st);
    return static_cast<int>(cudaGetLastError());
  }
#define DS_SHARD_CASE(K)                                  \
  case K:                                                 \
    shard_pass<K>(pass, tab, b, scratch, scratch_fs, st); \
    break;
  switch (k) {
    DS_SHARD_CASE(1)
    DS_SHARD_CASE(2)
    DS_SHARD_CASE(3)
    DS_SHARD_CASE(4)
    DS_SHARD_CASE(5)
    DS_SHARD_CASE(6)
    DS_SHARD_CASE(7)
    DS_SHARD_CASE(8)
  }
#undef DS_SHARD_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
