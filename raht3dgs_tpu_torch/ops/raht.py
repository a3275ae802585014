"""Shared RAHT types and helpers.

Counterpart of the shared part of ``raht3dgs_tpu/ops/raht.py``
(``num_levels``, ``RahtStructure``, ``RahtForwardResult``,
``_butterfly_ab``, ``_code_lanes`` / ``_lanes_code``), and the level-loop
helpers that the device predicted encoder runs (``_succ_active``,
``_pred_active``, ``_neighbor_pack``, ``_level_mask``). The dense level
loop of that module is not ported yet (ROADMAP queue A, item 17); the
codec's transform is ``ops/raht_span.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raht3dgs_tpu_torch.ops.morton import internal_payload_bits


def num_levels(depth: int, n: int) -> int:
    """Total butterfly levels for an ``n``-slot transform at octree depth J:
    the real ``3*depth`` levels plus the padding subtree's range."""
    return internal_payload_bits(depth, n) + 1


def max_int32_levels() -> int:
    """Largest level count representable with int32 codes (incl. pad bit)."""
    return 31


class RahtStructure(NamedTuple):
    drop_level: torch.Tensor    # (N,) int32: level the slot merged right-into-left; 0 = survivor
    subtree_w: torch.Tensor     # (N,) float: accumulated weight when merged (survivor: final)
    node_weights: torch.Tensor  # (N,) float: final accumulated node weights


class RahtForwardResult(NamedTuple):
    coeffs: torch.Tensor        # (N, D) coefficients, in sorted-code order
    weights: torch.Tensor       # (N,) final accumulated node weights
    structure: RahtStructure


def ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root on every device.

    ``torch.sqrt`` on a CPU tensor takes a vectorized path that misses the
    correctly rounded result in the last bit for about 1% of inputs; the
    CUDA one and numpy's are IEEE. The transform's coefficients (and so the
    stream's symbols at quantization ties) must not depend on the device,
    so CPU tensors go through numpy."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch.sqrt(x)


# Codes ride a wide float row gather as value-exact digits: float32 holds
# integers below 2^24 exactly, and three 22-bit digits cover every code.
_DIGIT_BITS = 22
_DIGIT_MASK = (1 << _DIGIT_BITS) - 1


def _code_lanes(codes: torch.Tensor, fdtype) -> torch.Tensor:
    """Split integer codes into (N, 3) exact float digits (low to high)."""
    c = codes.to(torch.int64)
    return torch.stack([(c & _DIGIT_MASK).to(fdtype),
                        ((c >> _DIGIT_BITS) & _DIGIT_MASK).to(fdtype),
                        ((c >> (2 * _DIGIT_BITS)) & _DIGIT_MASK).to(fdtype)], dim=1)


def _lanes_code(lanes: torch.Tensor, code_dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_code_lanes`."""
    lo, mid, hi = (lanes[:, i].to(torch.int64) for i in range(3))
    return (lo | (mid << _DIGIT_BITS) | (hi << (2 * _DIGIT_BITS))).to(code_dtype)


def _butterfly_ab(w0: torch.Tensor, w1: torch.Tensor):
    """Orthonormal butterfly coefficients; identity for zero-weight pairs."""
    denom = w0 + w1
    safe = denom > 0
    d = torch.where(safe, denom, torch.ones_like(denom))
    a = torch.where(safe, ieee_sqrt(w0 / d), torch.ones_like(denom))
    b = torch.where(safe, ieee_sqrt(w1 / d), torch.zeros_like(denom))
    return a, b


def _active_neighbors(active: torch.Tensor):
    """``(succ, pred)``: for each position the next strictly-greater active
    index (N if none) and the previous strictly-smaller one (-1 if none),
    int32.

    The JAX package takes a reversed ``cummin`` and a ``cummax``; PyTorch's
    scans with indices took ~1.3 ms each at 2^19 rows on an H100, 76 of the
    device encoder's 91 ms a step (``chip_smoke.py`` phase 11's profile),
    so the same integers come from one ``cumsum`` of the active flags (each
    active position's rank), a scatter of the active positions by rank, and
    two gathers."""
    N = active.shape[0]
    ar = torch.arange(N, dtype=torch.int32, device=active.device)
    cnt = torch.cumsum(active, 0, dtype=torch.int32)       # active in [0, i]
    # by rank; slot N stays N (past the last active), slot N + 1 takes the
    # writes of the inactive positions
    pos = torch.full((N + 2,), N, dtype=torch.int32, device=active.device)
    pos.scatter_(0, torch.where(active, cnt - 1, N + 1).long(), ar)
    succ = pos[cnt.long()]
    before = cnt - active.to(torch.int32)                  # active in [0, i)
    pred = torch.where(before > 0, pos[(before - 1).clamp(min=0).long()],
                       torch.full_like(before, -1))
    return succ, pred


def _succ_active(active: torch.Tensor) -> torch.Tensor:
    """For each position, the next strictly-greater active index (N if none)."""
    return _active_neighbors(active)[0]


def _pred_active(active: torch.Tensor) -> torch.Tensor:
    """For each position, the previous strictly-smaller active index (-1 if none)."""
    return _active_neighbors(active)[1]


def _neighbor_pack(active: torch.Tensor, codes: torch.Tensor, fields):
    """succ/pred indices of every position among the active ones, and the
    fields (each (N,) or (N, D)) followed by the code at both.

    Returns ``(succ, pred, at_succ, at_pred)``. The JAX package packs the
    fields and the codes (as float digits, ``_code_lanes``) into one wide
    row gather, a TPU gather workaround; here each is gathered directly,
    with the same values."""
    N = active.shape[0]
    succ, pred = _active_neighbors(active)
    succ_c = succ.clamp(max=N - 1).long()
    pred_c = pred.clamp(min=0).long()
    at_succ = [f[succ_c] for f in fields] + [codes[succ_c]]
    at_pred = [f[pred_c] for f in fields] + [codes[pred_c]]
    return succ, pred, at_succ, at_pred


def _level_mask(j: int, levels: int) -> int:
    """``2^levels - 2^j``: the code bits above level ``j``. Below 2^31 for
    the int32 code tier (``levels <= 31``), so it fits the codes' dtype."""
    return (1 << levels) - (1 << j)
