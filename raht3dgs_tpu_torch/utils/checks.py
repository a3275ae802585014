"""Validation helpers (counterpart of ``raht3dgs_tpu/utils/checks.py``).

- DC-coefficient sanity check ``max(T) == sqrt(N) * mean(C)``;
- Morton-order verification of a frame;
- run-boundary finder over coarsened blocks (``block_indices``);
- zigzag signed <-> unsigned mapping.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from raht3dgs_tpu_torch.utils.synth import morton_codes_np


def sanity_check_dc(
    T: np.ndarray, C: np.ndarray, rtol: float = 1e-5, atol: float = 1e-8
) -> bool:
    """DC identity for non-negative signals: max(T) == sqrt(N)*mean(C)."""
    T = np.asarray(T).ravel()
    C = np.asarray(C).ravel()
    if T.shape != C.shape:
        raise ValueError("T and C must have the same length")
    return bool(
        np.isclose(T.max(), np.sqrt(len(C)) * C.mean(), rtol=rtol, atol=atol)
    )


def is_frame_morton_ordered(
    V: np.ndarray, depth: int
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Check Morton ordering of integer-ish positions.

    Returns (error, V_sorted, sort_index): error is the L2 norm between the
    floored coordinates and their Morton-sorted version (0 iff already
    ordered).
    """
    V = np.asarray(V, dtype=np.float64)
    Vi = np.floor(V).astype(np.int64)
    codes = morton_codes_np(Vi, depth)
    index = np.argsort(codes, kind="stable")
    V_sorted = V[index]
    error = float(np.linalg.norm(Vi - Vi[index]))
    return error, V_sorted, index


def block_indices(V: np.ndarray, bsize: int) -> Tuple[np.ndarray, np.ndarray]:
    """Start indices of runs of points sharing a coarse block of size
    ``bsize`` (and the complementary non-start indices)."""
    V = np.asarray(V, dtype=np.float64)
    coarse = np.floor(V / bsize) * bsize
    change = np.abs(np.diff(coarse, axis=0)).sum(axis=1)
    variation = np.concatenate([[1.0], change])
    starts = np.nonzero(variation != 0)[0]
    rest = np.nonzero(variation == 0)[0]
    return starts, rest


def signed_to_unsigned(v: np.ndarray) -> np.ndarray:
    """Zigzag map matching the RLGR coder."""
    v = np.asarray(v, dtype=np.int64)
    return np.where(v >= 0, 2 * v, -2 * v - 1)


def unsigned_to_signed(u: np.ndarray) -> np.ndarray:
    """Inverse zigzag."""
    u = np.asarray(u, dtype=np.int64)
    half = u >> 1
    return np.where(u & 1 == 0, half, -half - 1)
