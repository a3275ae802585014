"""Compaction-based RAHT: partners are neighbours in a compacted prefix.

Counterpart of ``raht3dgs_tpu/ops/raht_compact.py``. The active nodes stay
compacted to a prefix of a fixed-size buffer in sorted-code order, so
sibling pairs are adjacent elements (k, k+1): the partner is a shift, not a
gather. Each level's shrink is one monotone scatter driven by a cumsum, and
a merged right sibling writes its detail coefficient and structure entry
once, into its original slot. Inactive rows scatter into a trash slot
(index N of an N+1 buffer), so no duplicate index meets a real one.

The same pairing and arithmetic as the dense loop (``ops/raht.py``), so the
outputs are bitwise its own. The ``-1`` sentinel assumes non-negative
codes, which the flipped int64 form of depth 21 is not: that tier is
refused, as in the JAX package.
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


def _scatter(n: int, dest: torch.Tensor, src: torch.Tensor, fill) -> torch.Tensor:
    """A buffer of ``n + 1`` rows of ``fill`` with ``src`` written at
    ``dest`` (row n is the trash slot)."""
    out = torch.full((n + 1,) + tuple(src.shape[1:]), fill, dtype=src.dtype,
                     device=src.device)
    out[dest] = src
    return out


def raht_forward_compact(codes: torch.Tensor, attributes: torch.Tensor,
                         weights: torch.Tensor, depth: int) -> RahtForwardResult:
    """Forward RAHT via per-level compaction; the contract of
    ``ops/raht.py:raht_forward`` (sorted unique codes, zero-weight pads)."""
    if flipped_tier(depth):
        raise NotImplementedError(
            "the compact formulation does not support the uint64 depth-21 code "
            "tier (its -1 sentinels and signed guards assume a signed "
            "dtype); use the span or dense implementation"
        )
    N, D = attributes.shape
    levels = num_levels(depth, N)
    fdtype = attributes.dtype
    dev = attributes.device
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    trash = torch.full((), N, dtype=torch.int64, device=dev)
    zrow = torch.zeros((1, D), dtype=fdtype, device=dev)
    z1 = torch.zeros((1,), dtype=fdtype, device=dev)
    f1 = torch.zeros((1,), dtype=torch.bool, device=dev)
    sentinel = torch.full((1,), -1, dtype=codes.dtype, device=dev)

    # output buffers in original slot space, with the trash slot at index N
    T_out = torch.cat([attributes, zrow])
    w_out = torch.cat([weights.to(fdtype), z1])
    drop = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    ws = torch.zeros(N + 1, dtype=fdtype, device=dev)

    c_codes, T, w, orig = codes, attributes, weights.to(fdtype), idx
    count = torch.full((), N, dtype=torch.int32, device=dev)
    for j in range(1, levels + 1):
        live = idx < count
        c = torch.where(live, c_codes, sentinel)
        nxt = torch.cat([c[1:], sentinel])
        left = live & (nxt >= 0) & (((c ^ nxt) & _level_mask(j, levels)) == 0)
        right = torch.cat([f1, left[:-1]])

        Tn = torch.cat([T[1:], zrow])
        wn = torch.cat([w[1:], z1])
        a, b = _butterfly_ab(w, wn)                   # valid on left rows
        lo = a[:, None] * T + b[:, None] * Tn         # the new left value
        detail = torch.cat([zrow, ((-b)[:, None] * T + a[:, None] * Tn)[:-1]])
        w_pair = w + wn
        w_pair_at_right = torch.cat([z1, w_pair[:-1]])

        # dropped right nodes: their final output slots (trash for the rest)
        out_slot = torch.where(right, orig.long(), trash)
        T_out[out_slot] = detail
        w_out[out_slot] = w_pair_at_right
        drop[out_slot] = j
        ws[out_slot] = w                              # subtree weight at the drop

        # survivors compact to the prefix
        T_new = torch.where(left[:, None], lo, T)
        w_new = torch.where(left, w_pair, w)
        keep = live & ~right
        pos = torch.cumsum(keep, 0, dtype=torch.int64) - 1
        dest = torch.where(keep, pos, trash)
        count = keep.sum(dtype=torch.int32)
        c_codes = _scatter(N, dest, c_codes, -1)[:N]
        T = _scatter(N, dest, T_new, 0)[:N]
        w = _scatter(N, dest, w_new, 0)[:N]
        orig = _scatter(N, dest, orig, 0)[:N]

    # survivors: final values back to their original slots
    out_slot = torch.where(idx < count, orig.long(), trash)
    T_out[out_slot] = T
    w_out[out_slot] = w
    ws[out_slot] = w
    return RahtForwardResult(
        coeffs=T_out[:N],
        weights=w_out[:N],
        structure=RahtStructure(drop_level=drop[:N], subtree_w=ws[:N],
                                node_weights=w_out[:N]),
    )
