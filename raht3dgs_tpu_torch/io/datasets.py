"""Benchmark point-cloud dataset registry (8iVFBv2, MVUB).

The port's own copy of ``raht3dgs_tpu/io/datasets.py``: frame ranges and
directory layouts of the reference registry, so existing dataset trees
work unchanged. Frame indices passed to :func:`get_pointcloud` are 1-based
relative to each sequence's start frame (reference convention).
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Tuple

import numpy as np

from raht3dgs_tpu_torch.io.ply import read_ply_8i, read_ply_mvub

DATASET_CONFIG = {
    "8iVFBv2": {
        "redandblack": {"start": 1450, "end": 1749},
        "soldier": {"start": 536, "end": 835},
        "longdress": {"start": 1051, "end": 1350},
        "loot": {"start": 1000, "end": 1299},
    },
    "MVUB": {
        "andrew9": {"start": 0, "end": 317},
        "david9": {"start": 0, "end": 215},
        "phil9": {"start": 0, "end": 244},
        "ricardo9": {"start": 0, "end": 215},
        "sarah9": {"start": 0, "end": 206},
    },
}

# MVUB sequences are voxelized at depth 9.
MVUB_DEPTH = 9


def _sequence_range(dataset: str, sequence: str):
    if dataset not in DATASET_CONFIG:
        warnings.warn(f"unknown dataset {dataset!r}")
        return None
    if sequence not in DATASET_CONFIG[dataset]:
        warnings.warn(f"unknown sequence {sequence!r} in dataset {dataset!r}")
        return None
    info = DATASET_CONFIG[dataset][sequence]
    return info["start"], info["end"]


def get_pointcloud_n_frames(dataset: str, sequence: str) -> Optional[int]:
    rng = _sequence_range(dataset, sequence)
    if rng is None:
        return None
    return rng[1] - rng[0] + 1


def frame_path(
    dataset: str, sequence: str, frame: int, data_root: str = "."
) -> Optional[str]:
    """PLY path of 1-based ``frame`` of a sequence under ``data_root``."""
    rng = _sequence_range(dataset, sequence)
    if rng is None:
        return None
    start, end = rng
    abs_frame = start - 1 + frame
    if not start <= abs_frame <= end:
        warnings.warn(
            f"frame {frame} (absolute {abs_frame}) outside [{start}, {end}]"
        )
        return None
    if dataset == "8iVFBv2":
        return os.path.join(
            data_root, "8iVFBv2", sequence, "Ply",
            f"{sequence}_vox10_{abs_frame:04d}.ply",
        )
    return os.path.join(
        data_root, "MVUB", sequence, "ply", f"frame{abs_frame:04d}.ply"
    )


def get_pointcloud(
    dataset: str, sequence: str, frame: int, data_root: str = "."
) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """Load (V, C_rgb, depth) for a dataset frame; None on failure."""
    path = frame_path(dataset, sequence, frame, data_root)
    if path is None:
        return None
    try:
        if dataset == "8iVFBv2":
            return read_ply_8i(path)
        V, C = read_ply_mvub(path)
        return V, C, MVUB_DEPTH
    except FileNotFoundError:
        warnings.warn(f"file not found: {path}")
        return None
    except Exception as e:
        warnings.warn(f"error reading {path}: {e}")
        return None
