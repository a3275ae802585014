"""Typed configuration shared by the library and the CLIs.

Counterpart of ``raht3dgs_tpu/config.py`` for the colour codec: the
reference codec's tuning constants as dataclass defaults. The JAX compile
cache field has no counterpart; the 3DGS dataclasses come with the 3DGS
slice (ROADMAP queue A, item 11).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass
class RuntimeConfig:
    """Execution environment knobs."""

    platform: str = "cuda"                  # "cuda" | "cpu"
    dtype: str = "float64"                  # "float64" parity / "float32" fast
    bucket: int = 1 << 13                   # shape-bucket granularity


@dataclass
class ColorCodecConfig:
    """encode_ply workload (the reference's encode_ply constants)."""

    depth: int = 18
    steps: Tuple[float, ...] = (1, 2, 4, 6, 8, 12, 16, 20, 24, 32, 64)
    decode: bool = True                     # full decode vs coeff-domain PSNR
    order_mode: str = "ragft"               # "ragft" | "weight_desc" | "morton"
