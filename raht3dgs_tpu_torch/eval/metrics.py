"""Quality metrics for reconstructed attributes and renders, on the host.

The port's own copy of ``raht3dgs_tpu/eval/metrics.py`` (the port imports
nothing of the JAX package): the reference codec's per-attribute error of
merged Gaussians, the per-group PSNR of the 3DGS payload and image PSNR.

``gs_group_psnr`` scores a float32 pair in one native pass
(``native/sq_diff.cpp``, built with g++ into ``_build/`` on first use and
called through ctypes, which releases the GIL): per-column sums of the
squared float32 differences, accumulated in float64 over fixed row blocks
by a thread pool, the same bits on any pool size. Every other input (float64
rows, other or mixed dtypes, strided views, no rows, empty groups) keeps
the numpy reductions of the JAX package's copy.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from raht3dgs_tpu_torch.codec._native import NativeLib, gxx_command
from raht3dgs_tpu_torch.ops.quantize import gs_attribute_groups
from raht3dgs_tpu_torch.utils.timing import count, spanned

_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)


def _configure(lib: ctypes.CDLL) -> None:
    lib.sq_diff_col_sums_f32.argtypes = [_f32p, _f32p, ctypes.c_size_t, ctypes.c_size_t,
                                         ctypes.c_int, _f64p]
    lib.sq_diff_col_sums_f32.restype = ctypes.c_int


NATIVE = NativeLib(
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native",
                 "sq_diff.cpp"),
    "libsqdiff.so", _configure, lambda src, out: gxx_command(src, out, ("-pthread",)))


def compute_attribute_metrics(
    original: Dict[str, np.ndarray],
    merged: Dict[str, np.ndarray],
    cluster_labels: np.ndarray,
) -> Dict[str, float]:
    """Per-attribute error between the original Gaussians and their
    cluster representatives (broadcast back through ``cluster_labels``):
    position, opacity and colour MSE and RMSE, quaternion distance
    ``1 - <q1, q2>^2`` and scale error in log space."""
    lab = np.asarray(cluster_labels)
    rec = {k: np.asarray(merged[k])[lab] for k in merged}

    out: Dict[str, float] = {}
    pos_mse = float(np.mean((original["means"] - rec["means"]) ** 2))
    out["position_mse"] = pos_mse
    out["position_rmse"] = float(np.sqrt(pos_mse))

    dot = np.abs(np.sum(original["quats"] * rec["quats"], axis=1))
    qd = 1.0 - dot**2
    out["quaternion_mean_dist"] = float(np.mean(qd))
    out["quaternion_max_dist"] = float(np.max(qd))

    slog = np.log(np.asarray(original["scales"]) + 1e-8)
    slog_r = np.log(np.asarray(rec["scales"]) + 1e-8)
    s_mse = float(np.mean((slog - slog_r) ** 2))
    out["scale_log_mse"] = s_mse
    out["scale_log_rmse"] = float(np.sqrt(s_mse))

    o_mse = float(np.mean((original["opacities"] - rec["opacities"]) ** 2))
    out["opacity_mse"] = o_mse
    out["opacity_rmse"] = float(np.sqrt(o_mse))

    c_mse = float(np.mean((original["colors"] - rec["colors"]) ** 2))
    out["color_mse"] = c_mse
    out["color_rmse"] = float(np.sqrt(c_mse))
    return out


def _f32_pair(a, b) -> bool:
    """Whether ``a`` and ``b`` are C-contiguous float32 (N, D) arrays of one
    shape with N, D >= 1: what the native pass reads."""
    return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
            and a.dtype == b.dtype == np.float32 and a.ndim == 2 and a.shape == b.shape
            and a.size > 0 and a.flags.c_contiguous and b.flags.c_contiguous)


def sq_diff_col_sums(a: np.ndarray, b: np.ndarray, threads: int = 0) -> np.ndarray:
    """``((a - b) ** 2).sum(0)`` of two C-contiguous float32 (N, D) arrays,
    N, D >= 1, as float64: each difference in float32, its square and the
    sums in float64, rows summed in fixed blocks and the blocks in order.
    ``threads`` <= 0 takes the hardware concurrency."""
    if not _f32_pair(a, b):
        raise ValueError("sq_diff_col_sums takes two C-contiguous float32 (N, D) "
                         "arrays of one shape with N, D >= 1")
    out = np.empty(a.shape[1], dtype=np.float64)
    rc = NATIVE.load().sq_diff_col_sums_f32(a.ctypes.data_as(_f32p), b.ctypes.data_as(_f32p),
                                            a.shape[0], a.shape[1], int(threads),
                                            out.ctypes.data_as(_f64p))
    if rc != 0:
        raise RuntimeError(f"sq_diff_col_sums_f32 failed (rc={rc})")
    return out


def _psnr_of(mse: float):
    return -10.0 * np.log10(mse + 1e-10)


@spanned("psnr")
def gs_group_psnr(
    original: np.ndarray,
    reconstructed: np.ndarray,
    groups: Optional[Mapping[str, Tuple[int, int]]] = None,
) -> Dict[str, float]:
    """Overall and per-group PSNR ``-10 log10(mse + 1e-10)`` of a packed
    (N, D) attribute matrix; groups default to the 3DGS layout adapted to
    the payload width (``gs_attribute_groups``).

    Two C-contiguous float32 arrays of one shape with N >= 1 and every
    group a non-empty column range take one fused native pass
    (:func:`sq_diff_col_sums`, counted as ``psnr_fused`` while tracing is
    on): the float32 differences squared and summed in float64, so the
    MSEs are at least as accurate as numpy's float32 mean. Anything else
    takes numpy's ``mean((a - b) ** 2)`` over the matrix and each group,
    float64 inputs bit for bit as before."""
    if groups is None:
        groups = gs_attribute_groups(original.shape[1])
    if _f32_pair(original, reconstructed) and all(
            0 <= lo < hi <= original.shape[1] for lo, hi in groups.values()):
        count("psnr_fused")
        col = sq_diff_col_sums(original, reconstructed)
        n = original.shape[0]

        def group_mse(lo, hi):
            return math.fsum(col[lo:hi]) / (n * (hi - lo))

        mse = group_mse(0, col.size)
    else:
        def group_mse(lo, hi):
            return float(np.mean((original[:, lo:hi] - reconstructed[:, lo:hi]) ** 2))

        mse = float(np.mean((original - reconstructed) ** 2))
    out: Dict[str, float] = {"psnr_all": _psnr_of(mse), "mse_all": mse}
    for name, (lo, hi) in groups.items():
        mse = group_mse(lo, hi)
        out[f"psnr_{name}"] = _psnr_of(mse)
        out[f"mse_{name}"] = mse
    return out


def image_psnr(img1: np.ndarray, img2: np.ndarray, peak: float = 1.0) -> float:
    """PSNR between two renders in ``[0, peak]``."""
    mse = float(np.mean((np.asarray(img1) - np.asarray(img2)) ** 2))
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(peak / np.sqrt(mse))
