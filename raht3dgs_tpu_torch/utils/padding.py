"""Shape-bucketing helpers (counterpart of ``raht3dgs_tpu/utils/padding.py``).

Frames pad up to a bucket boundary: the zero-weight padding slots are exact
no-ops in the transform, and bucketed shapes keep allocations reusable.
"""

from __future__ import annotations

import numpy as np

DEFAULT_BUCKET = 1 << 13  # 8192-row granularity


def round_up_bucket(n: int, bucket: int = DEFAULT_BUCKET) -> int:
    """Smallest multiple of ``bucket`` >= n (at least one bucket)."""
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def pad_rows(x: np.ndarray, n_rows: int, fill: float = 0.0) -> np.ndarray:
    """Pad (or pass through) ``x`` to ``n_rows`` leading rows with ``fill``."""
    if x.shape[0] == n_rows:
        return x
    if x.shape[0] > n_rows:
        raise ValueError(f"cannot pad {x.shape[0]} rows down to {n_rows}")
    pad_shape = (n_rows - x.shape[0],) + x.shape[1:]
    return np.concatenate([x, np.full(pad_shape, fill, dtype=x.dtype)], axis=0)
