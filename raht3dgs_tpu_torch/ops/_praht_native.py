"""ctypes binding of the native predicted-RAHT closed-loop kernels.

Counterpart of ``raht3dgs_tpu/ops/_praht_native.py``. ``native/praht.cpp``
(the port's byte-identical copy) replays the frozen numpy decode spec of
``ops/praht.py`` BITWISE; see the header comment there for the argument.
This module only marshals plan arrays; ``ops/praht.py`` picks it by its
``backend`` argument (``"native"``, the default, or ``"python"``, the
numpy spec itself). Unlike the JAX package's loader, which falls back to
numpy without a word, a failed build raises.

Built with ``-ffp-contract=off``: FMA contraction would change the
rounding of ``a*x0 + b*x1`` and break the bitwise decode contract.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from raht3dgs_tpu_torch.codec._native import NativeLib, gxx_command

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _configure(lib: ctypes.CDLL) -> None:
    for suff, fp in (("f32", _f32p), ("f64", _f64p)):
        fn = getattr(lib, f"praht_predict_{suff}")
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64, _i32p, fp, _i64p,
                       _i32p, fp, fp]
        fn.restype = None
        fn = getattr(lib, f"praht_butterfly_{suff}")
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64, _i64p, _i32p, _i32p,
                       fp, fp, ctypes.c_int, fp]
        fn.restype = None
        fn = getattr(lib, f"praht_decode_step_{suff}")
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       _i32p, fp, fp, ctypes.c_int64, _i32p, fp, fp,
                       ctypes.c_int64, _i64p, _i32p, _i32p, fp, fp, fp,
                       fp]
        fn.restype = None
    lib.praht_stencil.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _u64p, _u64p, _u8p,
        _i32p, _i32p, _i32p, _i64p, _i64p, _i32p, _u8p]
    lib.praht_stencil.restype = None


NATIVE = NativeLib(os.path.join(_NATIVE_DIR, "praht.cpp"), "libpraht.so",
                   _configure,
                   lambda src, out: gxx_command(src, out, ("-ffp-contract=off",)))


def _ptr(a: np.ndarray, tp):
    return a.ctypes.data_as(tp)


def _fp(dtype):
    return _f64p if np.dtype(dtype) == np.float64 else _f32p


def _contig(a: np.ndarray, dtype) -> np.ndarray:
    """``a`` as a C-contiguous array of ``dtype`` (a copy only if needed):
    every pointer handed to the library must be one."""
    return np.ascontiguousarray(a, dtype=dtype)


def predict(base_j: np.ndarray, csr_off: np.ndarray, csr_k: np.ndarray,
            csr_wt: np.ndarray, parent_means: np.ndarray,
            fdtype) -> np.ndarray:
    """num/den stencil accumulation, bitwise equal to
    ``ops.praht._predict_from_stencil``."""
    lib = NATIVE.load()
    pm = _contig(parent_means, fdtype)
    M = base_j.shape[0]
    D = pm.shape[1]
    out = np.empty((M, D), dtype=fdtype)
    fp = _fp(fdtype)
    fn = lib.praht_predict_f64 if fp is _f64p else lib.praht_predict_f32
    fn(M, D, _ptr(_contig(base_j, np.int32), _i32p), _ptr(pm, fp),
       _ptr(_contig(csr_off, np.int64), _i64p),
       _ptr(_contig(csr_k, np.int32), _i32p),
       _ptr(_contig(csr_wt, fdtype), fp), _ptr(out, fp))
    return out


def butterfly(T: np.ndarray, sub_off: np.ndarray, i0: np.ndarray,
              i1: np.ndarray, a: np.ndarray, b: np.ndarray,
              inverse: bool) -> np.ndarray:
    """One depth's butterflies on a COPY of ``T``, bitwise equal to
    ``ops.praht._forward3`` / ``_inverse3``."""
    lib = NATIVE.load()
    out = np.ascontiguousarray(T).copy()
    fp = _fp(out.dtype)
    fn = lib.praht_butterfly_f64 if fp is _f64p else lib.praht_butterfly_f32
    fn(out.shape[1], sub_off.shape[0] - 1, _ptr(_contig(sub_off, np.int64), _i64p),
       _ptr(_contig(i0, np.int32), _i32p), _ptr(_contig(i1, np.int32), _i32p),
       _ptr(_contig(a, out.dtype), fp), _ptr(_contig(b, out.dtype), fp),
       1 if inverse else 0, _ptr(out, fp))
    return out


def decode_step(lv, deq: np.ndarray, T_pred, m_prev: np.ndarray,
                fdtype) -> np.ndarray:
    """One fused per-depth reconstruct step, bitwise equal to the numpy
    statement sequence of ``ops.praht._reconstruct_lv`` (zeros, AC and
    survivor scatter, inverse butterflies, divide by sq)."""
    lib = NATIVE.load()
    M = lv.is_ac.shape[0]
    P = lv.idx_surv.shape[0]
    dt = np.dtype(fdtype)
    fp = _fp(dt)
    deq = _contig(deq, dt)
    m_prev = _contig(m_prev, dt)
    D = m_prev.shape[1]
    out = np.empty((M, D), dtype=dt)
    sub_off, i0, i1, a, b = lv.flat
    fn = (lib.praht_decode_step_f64 if fp is _f64p
          else lib.praht_decode_step_f32)
    tp = None if T_pred is None else _contig(T_pred, dt)
    # the numpy spec's "deq is None with n_ac > 0" case means AC rows stay
    # ZERO (skipped residuals, the prediction cascade): an empty deq buffer
    # scatters no row, and never reads n_ac rows past its end
    n_ac = deq.shape[0]
    if n_ac not in (0, lv.ac_rows.shape[0]):
        raise ValueError(
            f"deq has {n_ac} rows for {lv.ac_rows.shape[0]} AC slots")
    fn(M, D, n_ac, _ptr(lv.ac_rows, _i32p), _ptr(deq, fp),
       _ptr(tp, fp) if tp is not None else None, P,
       _ptr(lv.idx_surv, _i32p), _ptr(lv.sqrt_pw_flat, fp),
       _ptr(m_prev, fp), sub_off.shape[0] - 1, _ptr(sub_off, _i64p),
       _ptr(i0, _i32p), _ptr(i1, _i32p), _ptr(a, fp), _ptr(b, fp),
       _ptr(lv.sq_flat, fp), _ptr(out, fp))
    return out


_CAND_WT = (2.0, 2.0, 2.0, 1.0, 1.0, 1.0)  # frozen stencil weights


def stencil(parent_codes: np.ndarray, child_codes: np.ndarray, d: int,
            fdtype):
    """Integer stencil geometry: an exact match of ``ops.praht._stencil``
    plus the CSR layout :func:`predict` consumes, in one C pass."""
    lib = NATIVE.load()
    pc = np.ascontiguousarray(child_codes >> np.uint64(3))
    oct_ = np.ascontiguousarray((child_codes & np.uint64(7)).astype(np.uint8))
    parents = np.ascontiguousarray(parent_codes, dtype=np.uint64)
    M = pc.shape[0]
    P = parents.shape[0]
    base_j = np.empty(M, dtype=np.int32)
    cand_rows = np.empty(6 * M, dtype=np.int32)
    cand_k = np.empty(6 * M, dtype=np.int32)
    counts = np.zeros(6, dtype=np.int64)
    csr_off = np.empty(M + 1, dtype=np.int64)
    csr_k = np.empty(6 * M, dtype=np.int32)
    csr_cid = np.empty(6 * M, dtype=np.uint8)
    lib.praht_stencil(
        M, P, d, _ptr(pc, _u64p), _ptr(parents, _u64p), _ptr(oct_, _u8p),
        _ptr(base_j, _i32p), _ptr(cand_rows, _i32p), _ptr(cand_k, _i32p),
        _ptr(counts, _i64p), _ptr(csr_off, _i64p), _ptr(csr_k, _i32p),
        _ptr(csr_cid, _u8p))
    cands = []
    if d >= 2:
        for c in range(6):
            n = int(counts[c])
            cands.append((cand_rows[c * M:c * M + n].copy(),
                          cand_k[c * M:c * M + n].copy(), _CAND_WT[c]))
    n_csr = int(csr_off[-1])
    csr = (csr_off, csr_k[:n_csr].copy(),
           np.where(csr_cid[:n_csr] < 3, 2.0, 1.0).astype(fdtype))
    return base_j, tuple(cands), csr
