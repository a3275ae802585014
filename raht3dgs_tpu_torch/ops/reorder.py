"""Coefficient orders derived from the transform structure.

Counterpart of ``raht3dgs_tpu/ops/reorder.py``. The RA-GFT order is one
stable sort over a small integer key: survivors first, then octree-depth
groups from coarsest to finest, ascending index within a group. Every sort
is ``torch.argsort(..., stable=True)``, so ties resolve as in the JAX
package.
"""

from __future__ import annotations

import torch

ORDER_MODES = ("ragft", "weight_desc", "morton")


def ragft_order(drop_level: torch.Tensor) -> torch.Tensor:
    """RA-GFT permutation (positions into the sorted-code order), int32."""
    group = torch.div(drop_level + 2, 3, rounding_mode="floor")
    gmax = torch.max(group)
    key = torch.where(drop_level == 0, torch.zeros_like(group), 1 + gmax - group)
    return torch.argsort(key, stable=True).to(torch.int32)


def weight_descending_order(node_weights: torch.Tensor) -> torch.Tensor:
    """Descending final node weight (the MATLAB driver's order); stable, so
    ties keep Morton order."""
    return torch.argsort(-node_weights, stable=True).to(torch.int32)


def coefficient_order(structure, mode: str = "ragft") -> torch.Tensor:
    """Dispatch on the supported coefficient orderings."""
    if mode == "ragft":
        return ragft_order(structure.drop_level)
    if mode == "weight_desc":
        return weight_descending_order(structure.node_weights)
    if mode == "morton":
        n = structure.drop_level.shape[0]
        return torch.arange(n, dtype=torch.int32,
                            device=structure.drop_level.device)
    raise ValueError(f"unknown order mode {mode!r} (choose from {ORDER_MODES})")


def coefficient_order_batched(structure, mode: str = "ragft") -> torch.Tensor:
    """:func:`coefficient_order` of every frame of a (B, N) structure stack
    (each frame's own RA-GFT group range), int32 (B, N)."""
    drop = structure.drop_level
    if mode == "ragft":
        group = torch.div(drop + 2, 3, rounding_mode="floor")
        gmax = torch.amax(group, dim=1, keepdim=True)
        key = torch.where(drop == 0, torch.zeros_like(group), 1 + gmax - group)
        return torch.argsort(key, dim=1, stable=True).to(torch.int32)
    if mode == "weight_desc":
        return torch.argsort(-structure.node_weights, dim=1, stable=True).to(torch.int32)
    if mode == "morton":
        return torch.arange(drop.shape[1], dtype=torch.int32,
                            device=drop.device).expand(drop.shape).contiguous()
    raise ValueError(f"unknown order mode {mode!r} (choose from {ORDER_MODES})")


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """argsort of a permutation: the decode-side inverse."""
    return torch.argsort(order, stable=True).to(torch.int32)
