"""Uniform scalar quantization (counterpart of ``raht3dgs_tpu/ops/quantize.py``).

Given the same coefficients, the integer outputs equal the JAX package's.
``step`` is a tensor on the coefficients' device (scalar or ``(D,)``).
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

# 3DGS 56-channel attribute layout: [quats(4), scales(3), opacity(1), colors(48)]
GS_ATTRIBUTE_GROUPS = {
    "quats": (0, 4),
    "scales": (4, 7),
    "opacity": (7, 8),
    "colors": (8, 56),
}


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
