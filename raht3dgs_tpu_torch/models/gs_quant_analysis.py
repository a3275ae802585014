"""Per-attribute quantization strategies for the 3DGS payload.

Counterpart of ``raht3dgs_tpu/models/gs_quant_analysis.py`` (the research
toolkit of the reference's 3DGS debug script): in numpy on the host,
three step allocations over the coefficients' dynamic ranges
(range-normalized, importance-weighted by 1/ablation-PSNR, and their 50/50
hybrid) and per-group step vectors; on the device, the rendering
ablation (one reconstructed group at a time through ``eval/render.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

from raht3dgs_tpu_torch.ops.quantize import GS_ABLATION_PSNR_DB, GS_ATTRIBUTE_GROUPS
from raht3dgs_tpu_torch.utils.device import DeviceLike


def coefficient_ranges(
    coeffs: np.ndarray,
    groups: Mapping[str, Tuple[int, int]] = GS_ATTRIBUTE_GROUPS,
) -> Dict[str, float]:
    """Dynamic range (max - min) of the RAHT coefficients per group."""
    out = {}
    for name, (lo, hi) in groups.items():
        block = np.asarray(coeffs)[:, lo:hi]
        out[name] = float(block.max() - block.min())
    return out


def strategy_range_normalized(
    ranges: Mapping[str, float], target_levels: int = 256
) -> Dict[str, float]:
    """Equal level count per group: ``step = range / (levels - 1)``,
    floored at 1e-6 (a constant group must not get a zero step)."""
    return {k: max(r / (target_levels - 1), 1e-6) for k, r in ranges.items()}


def strategy_importance_weighted(
    ranges: Mapping[str, float],
    total_levels_budget: int = 1024,
    ablation_psnr: Mapping[str, float] = GS_ABLATION_PSNR_DB,
) -> Tuple[Dict[str, float], Dict[str, int]]:
    """Split a total level budget by importance = 1/ablation-PSNR; levels
    floored at 2, steps at 1e-6."""
    importance = {k: 1.0 / ablation_psnr[k] for k in ranges}
    total = sum(importance.values())
    levels = {k: max(int(total_levels_budget * importance[k] / total), 2) for k in ranges}
    steps = {k: max(ranges[k] / max(levels[k] - 1, 1), 1e-6) for k in ranges}
    return steps, levels


def strategy_hybrid(
    norm_steps: Mapping[str, float],
    weighted_steps: Mapping[str, float],
    hybrid_weight: float = 0.5,
) -> Dict[str, float]:
    return {
        k: norm_steps[k] * (1 - hybrid_weight) + weighted_steps[k] * hybrid_weight
        for k in norm_steps
    }


def quantization_strategy_report(
    coeffs: np.ndarray,
    uniform_step: float,
    target_levels: int = 256,
    total_levels_budget: int = 1024,
    groups: Mapping[str, Tuple[int, int]] = GS_ATTRIBUTE_GROUPS,
) -> str:
    """Human-readable analysis of the three strategies for a coefficient
    matrix (what the reference's debug script prints)."""
    ranges = coefficient_ranges(coeffs, groups)
    s1 = strategy_range_normalized(ranges, target_levels)
    s2, levels2 = strategy_importance_weighted(ranges, total_levels_budget)
    s3 = strategy_hybrid(s1, s2)

    lines = ["=== QUANTIZATION STRATEGY ANALYSIS ==="]
    lines.append(f"uniform step {uniform_step:g} gives per-group levels:")
    for k, r in ranges.items():
        lines.append(f"  {k:8s} range={r:10.4f}  uniform-levels={int(r / uniform_step + 1)}")
    lines.append(f"[1] range-normalized ({target_levels} levels each):")
    for k in ranges:
        lines.append(f"  {k:8s} step={s1[k]:.6f}")
    lines.append(f"[2] importance-weighted (budget {total_levels_budget}, 1/ablation-PSNR):")
    for k in ranges:
        lines.append(f"  {k:8s} step={s2[k]:.6f}  levels={levels2[k]}")
    lines.append("[3] hybrid (50/50):")
    for k in ranges:
        lines.append(f"  {k:8s} step={s3[k]:.6f}  levels={int(ranges[k] / s3[k] + 1)}")
    lines.append("recommended: importance-weighted (quats get the most levels)")
    return "\n".join(lines)


def per_group_step_vector(
    steps_by_group: Mapping[str, float],
    n_channels: int = 56,
    groups: Mapping[str, Tuple[int, int]] = GS_ATTRIBUTE_GROUPS,
) -> np.ndarray:
    out = np.ones(n_channels, dtype=np.float64)
    for k, (lo, hi) in groups.items():
        out[lo:hi] = steps_by_group[k]
    return out


def attribute_ablation(
    positions_world: np.ndarray,
    original_attrs: np.ndarray,
    reconstructed_attrs: np.ndarray,
    n_views: int = 5,
    image_size: int = 256,
    backend: str = "auto",
    groups: Mapping[str, Tuple[int, int]] = GS_ATTRIBUTE_GROUPS,
    seed: int = 0,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Render-PSNR when substituting ONE reconstructed group at a time,
    rendered on CUDA unless ``device="cpu"``.

    Low PSNR => that attribute's quantization error hurts rendering most
    (the study that produced GS_ABLATION_PSNR_DB).
    """
    from raht3dgs_tpu_torch.eval.render import render_comparison

    def scene_from(attrs):
        return {
            "means": positions_world,
            "quats": attrs[:, 0:4],
            "scales": np.abs(attrs[:, 4:7]),
            "opacities": np.clip(attrs[:, 7], 0, 1),
            "colors": attrs[:, 8:],
        }

    original_scene = scene_from(np.asarray(original_attrs))
    out: Dict[str, float] = {}
    for name, (lo, hi) in groups.items():
        mixed = np.asarray(original_attrs).copy()
        mixed[:, lo:hi] = np.asarray(reconstructed_attrs)[:, lo:hi]
        metrics = render_comparison(
            original_scene, scene_from(mixed), n_views=n_views,
            image_size=image_size, backend=backend, seed=seed, device=device,
        )
        out[name] = metrics.get("psnr_avg", float("nan"))
    return out
