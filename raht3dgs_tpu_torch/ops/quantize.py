"""Uniform scalar quantization (counterpart of ``raht3dgs_tpu/ops/quantize.py``).

Given the same coefficients, the integer outputs equal the JAX package's.
``step`` is a tensor on the coefficients' device (scalar or ``(D,)``). The
3DGS payload's per-attribute-group steps are built on the host as a
``(D,)`` step vector (``channel_steps``, ``importance_allocated_steps``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# 3DGS 56-channel attribute layout: [quats(4), scales(3), opacity(1), colors(48)]
GS_ATTRIBUTE_GROUPS: Dict[str, Tuple[int, int]] = {
    "quats": (0, 4),
    "scales": (4, 7),
    "opacity": (7, 8),
    "colors": (8, 56),
}

# Rendering-PSNR ablation of the reference's 3DGS debug script: the PSNR of a
# render when only that group is reconstructed through the codec. Lower
# means the group matters more, so it gets finer steps.
GS_ABLATION_PSNR_DB: Dict[str, float] = {
    "quats": 21.93,
    "scales": 26.36,
    "opacity": 42.22,
    "colors": 38.67,
}


def gs_attribute_groups(n_channels: int) -> Dict[str, Tuple[int, int]]:
    """The attribute groups of an ``n_channels``-wide payload: ``colors``
    spans ``(8, n_channels)`` and groups that start past the payload are
    left out."""
    out: Dict[str, Tuple[int, int]] = {}
    for name, (lo, hi) in GS_ATTRIBUTE_GROUPS.items():
        if lo >= n_channels:
            continue
        out[name] = (lo, n_channels if name == "colors" else min(hi, n_channels))
    return out


def quantize(x: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """Round-half-up uniform quantization ``floor(x/step + 0.5)``, int32."""
    return torch.floor(x / step + 0.5).to(torch.int32)


def dequantize(q: torch.Tensor, step: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    return q.to(dtype) * step


def quantize_deadzone(x: torch.Tensor, step: torch.Tensor,
                      f: torch.Tensor) -> torch.Tensor:
    """Sign-symmetric dead-zone quantization ``sign(x) * floor(|x|/step + f)``."""
    return (torch.sign(x) * torch.floor(torch.abs(x) / step + f)).to(torch.int32)


def dequantize_biased(q: torch.Tensor, step: torch.Tensor, delta: torch.Tensor,
                      dtype=torch.float64) -> torch.Tensor:
    """Reconstruct at ``sign(q) * (|q| + delta) * step``."""
    qf = q.to(dtype)
    return torch.sign(qf) * (torch.abs(qf) + delta) * step


def channel_steps(
    n_channels: int,
    base_step: float,
    group_steps: Optional[Mapping[str, float]] = None,
    groups: Mapping[str, Tuple[int, int]] = GS_ATTRIBUTE_GROUPS,
) -> np.ndarray:
    """A ``(D,)`` per-channel step vector from per-group overrides."""
    steps = np.full((n_channels,), float(base_step), dtype=np.float64)
    if group_steps:
        for name, s in group_steps.items():
            lo, hi = groups[name]
            steps[lo:hi] = float(s)
    return steps


def importance_allocated_steps(
    n_channels: int,
    level_budget: float = 1024.0,
    ablation_psnr: Mapping[str, float] = GS_ABLATION_PSNR_DB,
    groups: Mapping[str, Tuple[int, int]] = GS_ATTRIBUTE_GROUPS,
    coeff_ranges: Optional[Mapping[str, float]] = None,
) -> np.ndarray:
    """A ``(D,)`` step vector that splits a budget of quantization levels
    across the attribute groups by importance (1 / ablation PSNR):
    ``levels = max(int(budget * importance / total), 2)`` and
    ``step = max(range / max(levels - 1, 1), 1e-6)``, with each group's
    coefficient range from ``coeff_ranges`` (1.0 when not given, so the
    steps are relative)."""
    importance = {k: 1.0 / ablation_psnr[k] for k in groups}
    total = sum(importance.values())
    steps: Dict[str, float] = {}
    for name in groups:
        levels = max(int(level_budget * importance[name] / total), 2)
        rng = 1.0 if coeff_ranges is None else float(coeff_ranges[name])
        steps[name] = max(rng / max(levels - 1, 1), 1e-6)
    return channel_steps(n_channels, 1.0, steps, groups)
