"""Quality metrics for reconstructed attributes and renders, in numpy.

The port's own copy of ``raht3dgs_tpu/eval/metrics.py`` (the port imports
nothing of the JAX package): the reference codec's per-attribute error of
merged Gaussians, the per-group PSNR of the 3DGS payload and image PSNR.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from raht3dgs_tpu_torch.ops.quantize import gs_attribute_groups
from raht3dgs_tpu_torch.utils.timing import spanned


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


@spanned("psnr")
def gs_group_psnr(
    original: np.ndarray,
    reconstructed: np.ndarray,
    groups: Optional[Mapping[str, Tuple[int, int]]] = None,
) -> Dict[str, float]:
    """Overall and per-group PSNR ``-10 log10(mse + 1e-10)`` of a packed
    (N, D) attribute matrix; groups default to the 3DGS layout adapted to
    the payload width (``gs_attribute_groups``)."""
    if groups is None:
        groups = gs_attribute_groups(original.shape[1])
    out: Dict[str, float] = {}

    def psnr(a, b):
        mse = float(np.mean((a - b) ** 2))
        return -10.0 * np.log10(mse + 1e-10), mse

    p, m = psnr(original, reconstructed)
    out["psnr_all"] = p
    out["mse_all"] = m
    for name, (lo, hi) in groups.items():
        p, m = psnr(original[:, lo:hi], reconstructed[:, lo:hi])
        out[f"psnr_{name}"] = p
        out[f"mse_{name}"] = m
    return out


def image_psnr(img1: np.ndarray, img2: np.ndarray, peak: float = 1.0) -> float:
    """PSNR between two renders in ``[0, peak]``."""
    mse = float(np.mean((np.asarray(img1) - np.asarray(img2)) ** 2))
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(peak / np.sqrt(mse))
