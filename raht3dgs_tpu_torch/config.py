"""Typed configuration shared by the library and the CLIs.

Counterpart of ``raht3dgs_tpu/config.py``: the reference codec's tuning
constants as dataclass defaults, for the colour and the 3DGS workloads.
The JAX compile cache field has no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


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


@dataclass
class GsCodecConfig:
    """encode_3dgs workload (the reference's encode_3dgs constants)."""

    depth: int = 10
    steps: Tuple[float, ...] = (1, 4, 8, 12, 16, 20, 24, 32, 64)
    per_attribute: bool = False
    level_budget: int = 1024
    group_step_scales: Optional[Dict[str, float]] = None


@dataclass
class VoxelizeConfig:
    """3DGS N -> Nvox preprocessing (voxelize_3dgs)."""

    depth: int = 10
    weight_by_opacity: bool = True
    output_dir: Optional[str] = "output_compressed"


@dataclass
class RenderEvalConfig:
    """Rendering comparison (the reference's try_render_comparison)."""

    backend: str = "auto"                   # auto | gsplat | jax | preview | none
    n_views: int = 5
    image_size: int = 512
    seed: int = 0
    output_dir: Optional[str] = None
