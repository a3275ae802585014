"""Scan-propagated RAHT: each node's neighbours from two nearest-active scans.

Counterpart of ``raht3dgs_tpu/ops/raht_scan.py``. There the (code, T, w)
of the nearest active position at-or-after and at-or-before every position
ride two value-carrying ``lax.associative_scan`` s a level. Here each is a
"last valid index" scan (``cummax`` of the active positions, and its mirror
with a reversed ``cummin``) followed by one gather of the payloads: the
same values. A left sibling reads its partner one slot to the right of the
at-or-after scan, a right sibling one slot to the left of the at-or-before
scan; pairing, butterfly and bookkeeping are the dense loop's
(``ops/raht.py``), so the structure is bitwise its own and the
coefficients agree to 1e-12.

The ``-1`` code sentinel assumes non-negative codes, which the flipped
int64 form of depth 21 is not: that tier is refused, as in the JAX
package.
"""

from __future__ import annotations

import torch

from raht3dgs_tpu_torch.ops.morton import flipped_tier
from raht3dgs_tpu_torch.ops.raht import (
    RahtForwardResult,
    RahtStructure,
    _butterfly_ab,
    _level_mask,
    num_levels,
)


def _pull(active: torch.Tensor, payloads, reverse: bool):
    """For each position: whether an active position lies at-or-before it
    (at-or-after with ``reverse``), and the payloads there. Payloads are
    row 0's where none does: callers mask with the flag."""
    N = active.shape[0]
    idx = torch.arange(N, dtype=torch.int64, device=active.device)
    if reverse:
        src = torch.where(active, idx, torch.full_like(idx, N))
        src = torch.cummin(src.flip(0), dim=0).values.flip(0)
        valid = src < N
    else:
        src = torch.cummax(torch.where(active, idx, torch.full_like(idx, -1)), dim=0).values
        valid = src >= 0
    at = torch.where(valid, src, torch.zeros_like(src))
    return (valid,) + tuple(p[at] for p in payloads)


def _shift_fwd(x: torch.Tensor, fill) -> torch.Tensor:
    """x[i-1], with ``fill`` at i = 0."""
    return torch.cat([torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                 device=x.device), x[:-1]])


def _shift_bwd(x: torch.Tensor, fill) -> torch.Tensor:
    """x[i+1], with ``fill`` at i = N-1."""
    return torch.cat([x[1:], torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                        device=x.device)])


def raht_forward_scan(codes: torch.Tensor, attributes: torch.Tensor,
                      weights: torch.Tensor, depth: int) -> RahtForwardResult:
    """Forward RAHT with scan-propagated neighbour values; the contract of
    ``ops/raht.py:raht_forward``."""
    if flipped_tier(depth):
        raise NotImplementedError(
            "the scan formulation does not support the uint64 depth-21 code "
            "tier (its -1 sentinels and signed guards assume a signed "
            "dtype); use the span or dense implementation"
        )
    N, D = attributes.shape
    levels = num_levels(depth, N)
    fdtype = attributes.dtype
    dev = attributes.device
    T = attributes
    w = weights.to(fdtype)
    active = torch.ones(N, dtype=torch.bool, device=dev)
    drop = torch.zeros(N, dtype=torch.int32, device=dev)
    ws = torch.zeros(N, dtype=fdtype, device=dev)
    bad = torch.full((), -1, dtype=codes.dtype, device=dev)
    for j in range(1, levels + 1):
        mask = _level_mask(j, levels)
        # nearest-active payloads at-or-after / at-or-before each position
        nv, nc, nT, nw = _pull(active, (codes, T, w), reverse=True)
        pv, pc, pT, pw = _pull(active, (codes, T, w), reverse=False)
        # strictly after / strictly before: one shift
        succ_c = _shift_bwd(torch.where(nv, nc, bad), -1)
        pred_c = _shift_fwd(torch.where(pv, pc, bad), -1)
        left = active & (succ_c >= 0) & (((codes ^ succ_c) & mask) == 0)
        right = active & (pred_c >= 0) & (((codes ^ pred_c) & mask) == 0) & ~left

        partner_T = torch.where(left[:, None], _shift_bwd(nT, 0), _shift_fwd(pT, 0))
        partner_w = torch.where(left, _shift_bwd(nw, 0), _shift_fwd(pw, 0))
        w0 = torch.where(left, w, partner_w)
        w1 = torch.where(left, partner_w, w)
        a, b = _butterfly_ab(w0, w1)
        x0 = torch.where(left[:, None], T, partner_T)
        x1 = torch.where(left[:, None], partner_T, T)
        touched = left | right
        lo = a[:, None] * x0 + b[:, None] * x1
        hi = (-b)[:, None] * x0 + a[:, None] * x1
        T = torch.where(touched[:, None], torch.where(left[:, None], lo, hi), T)
        ws = torch.where(right, w, ws)
        w = torch.where(touched, w0 + w1, w)
        drop = torch.where(right, torch.full_like(drop, j), drop)
        active = active & ~right
    ws = torch.where(active, w, ws)
    return RahtForwardResult(coeffs=T, weights=w,
                             structure=RahtStructure(drop_level=drop, subtree_w=ws,
                                                     node_weights=w))
