// Native backend for the predicted-RAHT (PRAHT) host closed loop.
//
// ops/praht.py is the FROZEN decode spec (CLAUDE.md): every stream decodes
// by replaying its exact numpy float operations. These kernels replicate
// those operations BITWISE — identical IEEE-754 single/double arithmetic in
// the identical per-element order — so the Python layer may substitute them
// freely (tests/test_praht_native.py pins full-loop bit equality on both
// dtypes and both quantizer modes; RAHT3DGS_PRAHT_NATIVE=0 forces numpy).
//
// Bitwise contract, and why it holds:
//  * compiled with -ffp-contract=off (the Makefile/loader flag): no FMA
//    contraction, so a*x0 + b*x1 rounds exactly like numpy's two-op form;
//  * every accumulation runs in the numpy order: the prediction stencil
//    accumulates candidates in the frozen stencil order per row
//    (num = 4*pm[base]; then += wt*pm[k] per hit, ops/praht.py:336-345),
//    which is a per-row scalar chain — rows are independent, so walking
//    rows outer / candidates inner reproduces every chain exactly;
//  * butterfly pairs within a sub-level touch disjoint slots (RAHT pairing
//    invariant), so the numpy gather-all-then-scatter and this pair-by-pair
//    walk read identical inputs.
//
// Speedup source (~1-core host): one pass over memory per kernel instead of
// numpy's gather + scale + read-modify-write passes per stencil candidate,
// and no temporary (M, D) materializations in the butterflies.

#include <cstdint>
#include <cstring>

namespace {

template <typename F>
void predict_impl(std::int64_t M, std::int64_t D,
                  const std::int32_t* base_j, const F* parent_means,
                  const std::int64_t* csr_off, const std::int32_t* csr_k,
                  const F* csr_wt, F* out) {
  const F four = static_cast<F>(4.0);
  for (std::int64_t r = 0; r < M; ++r) {
    F* o = out + r * D;
    const F* pm = parent_means + static_cast<std::int64_t>(base_j[r]) * D;
    for (std::int64_t c = 0; c < D; ++c) o[c] = four * pm[c];
    F den = four;
    for (std::int64_t e = csr_off[r]; e < csr_off[r + 1]; ++e) {
      const F wt = csr_wt[e];
      const F* pn = parent_means + static_cast<std::int64_t>(csr_k[e]) * D;
      for (std::int64_t c = 0; c < D; ++c) o[c] = o[c] + wt * pn[c];
      den = den + wt;
    }
    for (std::int64_t c = 0; c < D; ++c) o[c] = o[c] / den;
  }
}

// One depth's butterflies, in place. Sub-level s covers pair rows
// [sub_off[s], sub_off[s+1]); forward walks sub-levels 0..n_sub-1, inverse
// walks them in reverse (numpy reversed(pairs)). a/b are per-pair scalars.
template <typename F>
void butterfly_impl(std::int64_t D, std::int64_t n_sub,
                    const std::int64_t* sub_off, const std::int32_t* i0,
                    const std::int32_t* i1, const F* a, const F* b,
                    int inverse, F* T) {
  for (std::int64_t si = 0; si < n_sub; ++si) {
    const std::int64_t s = inverse ? n_sub - 1 - si : si;
    for (std::int64_t p = sub_off[s]; p < sub_off[s + 1]; ++p) {
      F* r0 = T + static_cast<std::int64_t>(i0[p]) * D;
      F* r1 = T + static_cast<std::int64_t>(i1[p]) * D;
      const F ap = a[p], bp = b[p];
      if (inverse) {
        for (std::int64_t c = 0; c < D; ++c) {
          const F t0 = r0[c], t1 = r1[c];
          r0[c] = ap * t0 - bp * t1;
          r1[c] = bp * t0 + ap * t1;
        }
      } else {
        for (std::int64_t c = 0; c < D; ++c) {
          const F x0 = r0[c], x1 = r1[c];
          r0[c] = ap * x0 + bp * x1;
          r1[c] = -bp * x0 + ap * x1;
        }
      }
    }
  }
}

// One whole per-depth RECONSTRUCT step of the closed loop, fused:
//   T = zeros(M, D)
//   T[ac_rows]  = deq (+ T_pred[ac_rows] when predicting)
//   T[idx_surv] = sqrt_pw * m_prev
//   inverse butterflies in place
//   T /= sq
// Exactly the numpy statement sequence in ops/praht.py (praht_decode /
// praht_encode's reconstruct half) — ac and survivor rows are disjoint,
// every float op identical and in the same per-element order — in ONE
// memory pass over (M, D) instead of numpy's ~6 (the body cost that
// remained after the first round of kernels).
template <typename F>
void decode_step_impl(std::int64_t M, std::int64_t D, std::int64_t n_ac,
                      const std::int32_t* ac_rows, const F* deq,
                      const F* T_pred, std::int64_t P,
                      const std::int32_t* idx_surv, const F* sqrt_pw,
                      const F* m_prev, std::int64_t n_sub,
                      const std::int64_t* sub_off, const std::int32_t* i0,
                      const std::int32_t* i1, const F* a, const F* b,
                      const F* sq, F* T) {
  std::memset(T, 0, sizeof(F) * static_cast<size_t>(M) * D);
  for (std::int64_t r = 0; r < n_ac; ++r) {
    F* t = T + static_cast<std::int64_t>(ac_rows[r]) * D;
    const F* d = deq + r * D;
    if (T_pred) {
      const F* p = T_pred + static_cast<std::int64_t>(ac_rows[r]) * D;
      for (std::int64_t c = 0; c < D; ++c) t[c] = p[c] + d[c];
    } else {
      for (std::int64_t c = 0; c < D; ++c) t[c] = d[c];
    }
  }
  for (std::int64_t j = 0; j < P; ++j) {
    F* t = T + static_cast<std::int64_t>(idx_surv[j]) * D;
    const F* m = m_prev + j * D;
    const F w = sqrt_pw[j];
    for (std::int64_t c = 0; c < D; ++c) t[c] = w * m[c];
  }
  butterfly_impl<F>(D, n_sub, sub_off, i0, i1, a, b, /*inverse=*/1, T);
  for (std::int64_t r = 0; r < M; ++r) {
    const F s = sq[r];
    F* t = T + r * D;
    for (std::int64_t c = 0; c < D; ++c) t[c] = t[c] / s;
  }
}

// Integer-only stencil construction (ops/praht.py:_stencil). Candidate
// order is the FROZEN stencil order: face x, y, z (weight 2), then edges
// xy, xz, yz (weight 1). Outputs are exact integer matches of the numpy
// path: base_j by merge join (pc is sorted and every parent exists, so
// lower_bound == the join cursor), per-candidate hit rows + parent
// indices, and the CSR form (per-row candidate lists in candidate order)
// that praht_predict consumes.
struct StepAxis {
  std::uint64_t mask, low;
};

static inline std::uint64_t step_axis(std::uint64_t code, StepAxis ax,
                                      bool pos, bool* valid) {
  const std::uint64_t m = code & ax.mask;
  if (pos) {
    *valid = m != ax.mask;
    return (((code | ~ax.mask) + ax.low) & ax.mask) | (code & ~ax.mask);
  }
  *valid = m != 0;
  return ((m - ax.low) & ax.mask) | (code & ~ax.mask);
}

static inline std::int64_t lower_bound_u64(const std::uint64_t* arr,
                                           std::int64_t n,
                                           std::uint64_t key) {
  std::int64_t lo = 0, hi = n;
  while (lo < hi) {
    const std::int64_t mid = (lo + hi) >> 1;
    if (arr[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

}  // namespace

extern "C" {

// cand_rows/cand_k: capacity 6*M each, candidate c occupying
// [c*M, c*M + counts[c]). csr_off: (M+1,); csr_k/csr_cid: capacity 6*M.
void praht_stencil(std::int64_t M, std::int64_t P, int d,
                   const std::uint64_t* pc, const std::uint64_t* parents,
                   const std::uint8_t* oct, std::int32_t* base_j,
                   std::int32_t* cand_rows, std::int32_t* cand_k,
                   std::int64_t* counts, std::int64_t* csr_off,
                   std::int32_t* csr_k, std::uint8_t* csr_cid) {
  // base_j: merge join over two sorted sequences
  {
    std::int64_t j = 0;
    for (std::int64_t r = 0; r < M; ++r) {
      while (j < P && parents[j] < pc[r]) ++j;
      base_j[r] = static_cast<std::int32_t>(j);
    }
  }
  for (int c = 0; c < 6; ++c) counts[c] = 0;
  csr_off[0] = 0;
  if (d < 2) {
    for (std::int64_t r = 0; r < M; ++r) csr_off[r + 1] = 0;
    return;
  }
  // _axis_masks(d-1): z bits 3i, y bits 3i+1, x bits 3i+2 for i < d-1
  std::uint64_t mz = 0;
  for (int i = 0; i < d - 1; ++i) mz |= 1ull << (3 * i);
  const StepAxis ax[3] = {{mz << 2, 4ull}, {mz << 1, 2ull}, {mz, 1ull}};
  std::int64_t ncsr = 0;
  for (std::int64_t r = 0; r < M; ++r) {
    const std::uint64_t code = pc[r];
    // octant digit = z + 2y + 4x -> per-axis step direction
    const bool pos[3] = {(oct[r] >> 2 & 1) != 0, (oct[r] >> 1 & 1) != 0,
                         (oct[r] & 1) != 0};
    std::uint64_t face[3];
    bool fvalid[3];
    std::uint64_t cand[6];
    bool valid[6];
    for (int a = 0; a < 3; ++a) {
      face[a] = step_axis(code, ax[a], pos[a], &fvalid[a]);
      cand[a] = face[a];
      valid[a] = fvalid[a];
    }
    static const int EDGES[3][2] = {{0, 1}, {0, 2}, {1, 2}};
    for (int e = 0; e < 3; ++e) {
      const int a = EDGES[e][0], b = EDGES[e][1];
      bool v;
      cand[3 + e] = step_axis(face[a], ax[b], pos[b], &v);
      valid[3 + e] = v && fvalid[a];
    }
    for (int c = 0; c < 6; ++c) {
      if (!valid[c]) continue;
      std::int64_t k = lower_bound_u64(parents, P, cand[c]);
      if (k >= P) k = P - 1;  // numpy's min(searchsorted, last)
      if (parents[k] != cand[c]) continue;
      cand_rows[c * M + counts[c]] = static_cast<std::int32_t>(r);
      cand_k[c * M + counts[c]] = static_cast<std::int32_t>(k);
      ++counts[c];
      csr_k[ncsr] = static_cast<std::int32_t>(k);
      csr_cid[ncsr] = static_cast<std::uint8_t>(c);
      ++ncsr;
    }
    csr_off[r + 1] = ncsr;
  }
}

void praht_predict_f32(std::int64_t M, std::int64_t D,
                       const std::int32_t* base_j, const float* parent_means,
                       const std::int64_t* csr_off, const std::int32_t* csr_k,
                       const float* csr_wt, float* out) {
  predict_impl<float>(M, D, base_j, parent_means, csr_off, csr_k, csr_wt,
                      out);
}

void praht_predict_f64(std::int64_t M, std::int64_t D,
                       const std::int32_t* base_j, const double* parent_means,
                       const std::int64_t* csr_off, const std::int32_t* csr_k,
                       const double* csr_wt, double* out) {
  predict_impl<double>(M, D, base_j, parent_means, csr_off, csr_k, csr_wt,
                       out);
}

void praht_butterfly_f32(std::int64_t D, std::int64_t n_sub,
                         const std::int64_t* sub_off, const std::int32_t* i0,
                         const std::int32_t* i1, const float* a,
                         const float* b, int inverse, float* T) {
  butterfly_impl<float>(D, n_sub, sub_off, i0, i1, a, b, inverse, T);
}

void praht_butterfly_f64(std::int64_t D, std::int64_t n_sub,
                         const std::int64_t* sub_off, const std::int32_t* i0,
                         const std::int32_t* i1, const double* a,
                         const double* b, int inverse, double* T) {
  butterfly_impl<double>(D, n_sub, sub_off, i0, i1, a, b, inverse, T);
}

void praht_decode_step_f32(std::int64_t M, std::int64_t D,
                           std::int64_t n_ac, const std::int32_t* ac_rows,
                           const float* deq, const float* T_pred,
                           std::int64_t P, const std::int32_t* idx_surv,
                           const float* sqrt_pw, const float* m_prev,
                           std::int64_t n_sub, const std::int64_t* sub_off,
                           const std::int32_t* i0, const std::int32_t* i1,
                           const float* a, const float* b, const float* sq,
                           float* T) {
  decode_step_impl<float>(M, D, n_ac, ac_rows, deq, T_pred, P, idx_surv,
                          sqrt_pw, m_prev, n_sub, sub_off, i0, i1, a, b,
                          sq, T);
}

void praht_decode_step_f64(std::int64_t M, std::int64_t D,
                           std::int64_t n_ac, const std::int32_t* ac_rows,
                           const double* deq, const double* T_pred,
                           std::int64_t P, const std::int32_t* idx_surv,
                           const double* sqrt_pw, const double* m_prev,
                           std::int64_t n_sub, const std::int64_t* sub_off,
                           const std::int32_t* i0, const std::int32_t* i1,
                           const double* a, const double* b,
                           const double* sq, double* T) {
  decode_step_impl<double>(M, D, n_ac, ac_rows, deq, T_pred, P, idx_surv,
                           sqrt_pw, m_prev, n_sub, sub_off, i0, i1, a, b,
                           sq, T);
}

}  // extern "C"
