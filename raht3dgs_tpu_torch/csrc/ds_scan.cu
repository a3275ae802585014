// Double-single (hi, lo) inclusive prefix sums of float32 columns, for Hopper.
//
// Replaces the TPU kernels of raht3dgs_tpu/ops/pallas_scan.py: _scan_kernel
// (entry ds_cumsum_pallas, the (N, K) row layout) and _scan_kernel_t (entry
// ds_cumsum_pallas_t, the transposed (K, N) layout). Both layouts are one
// kernel here: element (row, col) lives at x[row * rs + col * cs], so the
// row entry passes (rs, cs) = (K, 1) and the transposed entry (1, N).
//
// Numerics are the TPU kernel's error-free two-sum and ds combine
// (pallas_scan.py:_two_sum/_ds_add), ~48 mantissa bits. Every add and
// subtract is an explicit round-to-nearest intrinsic, so nvcc can neither
// contract nor reorder them; the library is built without fast math. The
// association depends on the row count alone (never on K, the layout or
// the strides), so one column scanned alone or inside a wider pack gives
// the same bits, and integer-valued lanes whose partial sums stay below
// 2^24 come out exact under it.
//
// Design. The TPU kernel walks row chunks on a sequential grid with a carry
// in VMEM; blocks on Hopper run in parallel and carry nothing, so the scan
// takes three launches:
//   1. tile_reduce: each block reduces its 2048-row tile to per-column
//      (hi, lo) totals;
//   2. the tile totals are scanned by the same procedure (one block while
//      there are at most 2048 tiles, i.e. N <= 4M rows; deeper otherwise);
//   3. tile_scan: each block scans its tile and adds the carry in front.
// Inside a block, each thread owns 8 consecutive rows and reduces them
// sequentially; a warp scan with __shfl_up_sync on hi and lo and a pass
// over the 8 warp totals in shared memory give each thread its exclusive
// prefix, and the thread re-reads its rows (from L1/L2) to write them.
//
// Bound on the card: bytes. At the codec's fused pack (2^19, 4) the
// function reads 8 MiB and writes 16 MiB, about 7.5 us at 3.35 TB/s, so
// launch latency of the passes weighs as much as the traffic. The design
// keeps three launches with no host synchronisation between them and a
// single-block middle pass. What it leaves on the table (PERF.md has the
// measured time): a thread's 8-row block makes a warp's loads strided
// rather than coalesced, and the input is read three times (once to
// reduce, twice in the scan pass). Coalesced warp-striped loads and a
// decoupled look-back single pass are the next steps for speed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // rows per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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

template <int K>
__device__ __forceinline__ void thread_reduce(const float* __restrict__ in_hi,
                                              const float* __restrict__ in_lo,
                                              long long n, long long rs,
                                              long long cs, long long row0,
                                              float (&hi)[K], float (&lo)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    hi[k] = 0.f;
    lo[k] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long r = row0 + j;
    if (r < n) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const long long off = r * rs + k * cs;
        ds_add(hi[k], lo[k], in_hi[off], in_lo ? in_lo[off] : 0.f);
      }
    }
  }
}

// Exclusive block-wide prefix (ph, pl) of the per-thread totals (hi, lo),
// and the block total (th, tl). Every thread of the block must call it.
template <int K>
__device__ __forceinline__ void block_scan(float (&hi)[K], float (&lo)[K],
                                           float (&ph)[K], float (&pl)[K],
                                           float (&th)[K], float (&tl)[K]) {
  __shared__ float s_hi[kWarps][K];
  __shared__ float s_lo[kWarps][K];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float oh = __shfl_up_sync(kFull, hi[k], off);
      const float ol = __shfl_up_sync(kFull, lo[k], off);
      if (lane >= off) ds_add(hi[k], lo[k], oh, ol);
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s_hi[warp][k] = hi[k];
      s_lo[warp][k] = lo[k];
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
    float wh = 0.f, wl = 0.f;
    th[k] = 0.f;
    tl[k] = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) ds_add(wh, wl, s_hi[w][k], s_lo[w][k]);
      ds_add(th[k], tl[k], s_hi[w][k], s_lo[w][k]);
    }
    ds_add(wh, wl, eh, el);
    ph[k] = wh;
    pl[k] = wl;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    tile_reduce(const float* __restrict__ in_hi,
                const float* __restrict__ in_lo, long long n, long long rs,
                long long cs, float* __restrict__ tot_hi,
                float* __restrict__ tot_lo) {
  const long long row0 =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  float hi[K], lo[K], ph[K], pl[K], th[K], tl[K];
  thread_reduce<K>(in_hi, in_lo, n, rs, cs, row0, hi, lo);
  block_scan<K>(hi, lo, ph, pl, th, tl);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      tot_hi[(long long)blockIdx.x * K + k] = th[k];
      tot_lo[(long long)blockIdx.x * K + k] = tl[k];
    }
  }
}

// carry_hi/carry_lo: inclusive scan of the tile totals, row-major (T, K);
// block b adds row b - 1 in front. nullptr: a single tile, no carry.
template <int K>
__global__ void __launch_bounds__(kThreads)
    tile_scan(const float* __restrict__ in_hi, const float* __restrict__ in_lo,
              long long n, long long rs, long long cs,
              const float* __restrict__ carry_hi,
              const float* __restrict__ carry_lo, float* __restrict__ out_hi,
              float* __restrict__ out_lo) {
  const long long row0 =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  float hi[K], lo[K], ph[K], pl[K], th[K], tl[K];
  thread_reduce<K>(in_hi, in_lo, n, rs, cs, row0, hi, lo);
  block_scan<K>(hi, lo, ph, pl, th, tl);
  float run_h[K], run_l[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    run_h[k] = 0.f;
    run_l[k] = 0.f;
    if (carry_hi != nullptr && blockIdx.x > 0) {
      const long long c = ((long long)blockIdx.x - 1) * K + k;
      run_h[k] = carry_hi[c];
      run_l[k] = carry_lo[c];
    }
    ds_add(run_h[k], run_l[k], ph[k], pl[k]);
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long r = row0 + j;
    if (r < n) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const long long off = r * rs + k * cs;
        ds_add(run_h[k], run_l[k], in_hi[off], in_lo ? in_lo[off] : 0.f);
        out_hi[off] = run_h[k];
        out_lo[off] = run_l[k];
      }
    }
  }
}

template <int K>
void scan_level(const float* in_hi, const float* in_lo, long long n,
                long long rs, long long cs, float* out_hi, float* out_lo,
                float* scratch, cudaStream_t st) {
  const long long t = (n + kTile - 1) / kTile;
  if (t <= 1) {
    tile_scan<K><<<1, kThreads, 0, st>>>(in_hi, in_lo, n, rs, cs, nullptr,
                                         nullptr, out_hi, out_lo);
    return;
  }
  float* tot_hi = scratch;
  float* tot_lo = tot_hi + t * K;
  float* inc_hi = tot_lo + t * K;
  float* inc_lo = inc_hi + t * K;
  tile_reduce<K><<<(unsigned)t, kThreads, 0, st>>>(in_hi, in_lo, n, rs, cs,
                                                   tot_hi, tot_lo);
  scan_level<K>(tot_hi, tot_lo, t, K, 1, inc_hi, inc_lo, inc_lo + t * K, st);
  tile_scan<K><<<(unsigned)t, kThreads, 0, st>>>(
      in_hi, in_lo, n, rs, cs, inc_hi, inc_lo, out_hi, out_lo);
}

}  // namespace

extern "C" {

// Floats of scratch that ds_cumsum_f32 needs for n rows of k columns.
long long ds_scan_scratch_floats(long long n, int k) {
  long long total = 0;
  while (n > kTile) {
    const long long t = (n + kTile - 1) / kTile;
    total += 4 * t * k;
    n = t;
  }
  return total;
}

// Inclusive compensated prefix sums along the rows of x (n rows, k <= 8
// columns, element (r, c) at x[r * rs + c * cs]) into out_hi/out_lo of the
// same layout. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launches (-1 for an unsupported k).
int ds_cumsum_f32(const float* x, long long n, int k, long long rs,
                  long long cs, float* out_hi, float* out_lo, float* scratch,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: scan_level<1>(x, nullptr, n, rs, cs, out_hi, out_lo, scratch, st); break;
    case 2: scan_level<2>(x, nullptr, n, rs, cs, out_hi, out_lo, scratch, st); break;
    case 3: scan_level<3>(x, nullptr, n, rs, cs, out_hi, out_lo, scratch, st); break;
    case 4: scan_level<4>(x, nullptr, n, rs, cs, out_hi, out_lo, scratch, st); break;
    case 5: scan_level<5>(x, nullptr, n, rs, cs, out_hi, out_lo, scratch, st); break;
    case 6: scan_level<6>(x, nullptr, n, rs, cs, out_hi, out_lo, scratch, st); break;
    case 7: scan_level<7>(x, nullptr, n, rs, cs, out_hi, out_lo, scratch, st); break;
    case 8: scan_level<8>(x, nullptr, n, rs, cs, out_hi, out_lo, scratch, st); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
