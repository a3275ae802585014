"""RAHT as dense masked butterflies, one level at a time.

Counterpart of ``raht3dgs_tpu/ops/raht.py`` (its docstring lays out the
formulation): a length-N state of coefficients, node weights and an active
mask advances through every butterfly level; at level ``j`` an active node
pairs with its active successor iff their codes agree on bits ``[j, L)``.
The JAX package runs the levels in one ``lax.fori_loop``; here they are a
Python loop of PyTorch ops on the codes' device. Successor and predecessor
come from one ``cumsum`` of the active flags, a scatter by rank and two
gathers (:func:`_active_neighbors`), the same integers as the JAX
package's ``cummin`` / ``cummax``.

This is the bitwise golden of the level-loop family (``ops/raht_compact.py``
and ``ops/raht_scan.py`` give its pairing and arithmetic); the codec's fast
path is the closed-form ``ops/raht_span.py``. It runs every code tier,
the flipped int64 form of depth 21 included (``ops/morton.py``): XOR and
masks see through the flip.
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
# integers below 2^24 exactly; two 22-bit digits and a 20-bit top digit
# cover the 64 bits of an int64 code.
_DIGIT_BITS = 22
_DIGIT_MASK = (1 << _DIGIT_BITS) - 1
# the top digit stops at bit 63: a wider mask would pick up the ones an
# arithmetic shift drags in from a negative (flipped, depth-21) code
_TOP_MASK = (1 << (64 - 2 * _DIGIT_BITS)) - 1


def _code_lanes(codes: torch.Tensor, fdtype) -> torch.Tensor:
    """Split integer codes into (N, 3) exact float digits (low to high)."""
    c = codes.to(torch.int64)
    return torch.stack([(c & _DIGIT_MASK).to(fdtype),
                        ((c >> _DIGIT_BITS) & _DIGIT_MASK).to(fdtype),
                        ((c >> (2 * _DIGIT_BITS)) & _TOP_MASK).to(fdtype)], dim=1)


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
    """``2^levels - 2^j``: the code bits above level ``j``, as a Python int
    that fits the codes' dtype. Below 2^31 for the int32 tier (``levels <=
    31``); for 64 levels (depth 21) 2^64 wraps as in the JAX package's
    uint64 arithmetic: bits ``j..63`` set, read as a signed int64 (0 at the
    final level ``j == 64``: merge everything)."""
    m = (1 << levels) - (1 << j)
    return m - (1 << 64) if m >= 1 << 63 else m


def _pairs(active, codes, mask: int, succ, pred, scode, pcode):
    """(left, right) of one level: an active node pairs with its active
    successor (left) or predecessor (right) when their codes agree above
    the level; ``~left`` keeps the two exclusive."""
    N = active.shape[0]
    left = active & (succ < N) & (((codes ^ scode) & mask) == 0)
    right = active & (pred >= 0) & (((codes ^ pcode) & mask) == 0) & ~left
    return left, right


def raht_forward(codes: torch.Tensor, attributes: torch.Tensor,
                 weights: torch.Tensor, depth: int) -> RahtForwardResult:
    """Forward RAHT over Morton-sorted unique ``codes`` (pads: sentinel
    codes, zero weights, finite attributes).

    Returns the coefficients in place (slot k holds the coefficient the
    reference's ``RAHT2_optimized`` leaves at position k), the final node
    weights and the replayable structure, as the JAX package's
    ``raht_forward``."""
    N, D = attributes.shape
    levels = num_levels(depth, N)
    fdtype = attributes.dtype
    dev = attributes.device
    T = attributes
    w = weights.to(fdtype)
    active = torch.ones(N, dtype=torch.bool, device=dev)
    drop = torch.zeros(N, dtype=torch.int32, device=dev)
    ws = torch.zeros(N, dtype=fdtype, device=dev)
    for j in range(1, levels + 1):
        succ, pred, (sT, sw, scode), (pT, pw, pcode) = _neighbor_pack(active, codes, [T, w])
        left, right = _pairs(active, codes, _level_mask(j, levels), succ, pred, scode, pcode)
        touched = left | right
        Tp = torch.where(left[:, None], sT, pT)
        wp = torch.where(left, sw, pw)
        w0 = torch.where(left, w, wp)
        w1 = torch.where(left, wp, w)
        a, b = _butterfly_ab(w0, w1)
        x0 = torch.where(left[:, None], T, Tp)
        x1 = torch.where(left[:, None], Tp, T)
        lo = a[:, None] * x0 + b[:, None] * x1
        hi = (-b)[:, None] * x0 + a[:, None] * x1
        T = torch.where(touched[:, None], torch.where(left[:, None], lo, hi), T)
        ws = torch.where(right, w, ws)
        w = torch.where(touched, w0 + w1, w)
        drop = torch.where(right, torch.full_like(drop, j), drop)
        active = active & ~right
    ws = torch.where(active, w, ws)  # survivors: final weight
    return RahtForwardResult(coeffs=T, weights=w,
                             structure=RahtStructure(drop_level=drop, subtree_w=ws,
                                                     node_weights=w))


def raht_structure(codes: torch.Tensor, weights: torch.Tensor,
                   depth: int) -> RahtStructure:
    """Structure-only forward pass (no attributes): the decoder's prelude,
    from positions alone."""
    N = codes.shape[0]
    levels = num_levels(depth, N)
    fdtype = weights.dtype
    dev = codes.device
    w = weights
    active = torch.ones(N, dtype=torch.bool, device=dev)
    drop = torch.zeros(N, dtype=torch.int32, device=dev)
    ws = torch.zeros(N, dtype=fdtype, device=dev)
    for j in range(1, levels + 1):
        succ, pred, (sw, scode), (pw, pcode) = _neighbor_pack(active, codes, [w])
        left, right = _pairs(active, codes, _level_mask(j, levels), succ, pred, scode, pcode)
        wp = torch.where(left, sw, pw)
        ws = torch.where(right, w, ws)
        w = torch.where(left | right, w + wp, w)
        drop = torch.where(right, torch.full_like(drop, j), drop)
        active = active & ~right
    ws = torch.where(active, w, ws)
    return RahtStructure(drop_level=drop, subtree_w=ws, node_weights=w)


def raht_inverse(coeffs: torch.Tensor, structure: RahtStructure,
                 depth: int) -> torch.Tensor:
    """Inverse RAHT: replay the pairing structure top-down. At level ``j``
    the active set before the forward merge is ``{drop == 0} | {drop >=
    j}``; right siblings are ``drop == j``, their left partner is their
    predecessor in that set, and the pair's weights come back from
    ``subtree_w``."""
    N, D = coeffs.shape
    levels = num_levels(depth, N)
    fdtype = coeffs.dtype
    drop = structure.drop_level
    ws = structure.subtree_w.to(fdtype)
    C = coeffs
    wcur = ws
    for j in range(levels, 0, -1):
        active_pre = (drop == 0) | (drop >= j)
        right = drop == j
        succ, pred = _active_neighbors(active_pre)
        succ_c = succ.clamp(max=N - 1).long()
        pred_c = pred.clamp(min=0).long()
        left = active_pre & (succ < N) & (drop[succ_c] == j)
        touched = left | right
        Cp = torch.where(left[:, None], C[succ_c], C[pred_c])
        wcur_p = torch.where(left, wcur[succ_c], wcur[pred_c])
        ws_p = torch.where(left, ws[succ_c], ws[pred_c])
        w1 = torch.where(left, ws_p, ws)
        # untouched rows are masked below; zero their w0, which may be
        # negative there, so the square roots see no invalid input
        w0 = torch.where(touched, torch.where(left, wcur, wcur_p) - w1,
                         torch.zeros_like(w1))
        a, b = _butterfly_ab(w0, w1)
        t0 = torch.where(left[:, None], C, Cp)
        t1 = torch.where(left[:, None], Cp, C)
        lo = a[:, None] * t0 - b[:, None] * t1
        hi = b[:, None] * t0 + a[:, None] * t1
        C = torch.where(touched[:, None], torch.where(left[:, None], lo, hi), C)
        wcur = torch.where(left, w0, torch.where(right, w1, wcur))
    return C


def get_forward_impl(name: str = "dense"):
    """A forward-transform implementation by name: "span" (closed form, the
    codec's default, ``ops/raht_span.py``), "dense" (this module, the
    bitwise golden for 1e-12 crosschecks), "compact" (prefix compaction)
    or "scan" (scan-propagated neighbours). All give the same structure."""
    if name == "dense":
        return raht_forward
    if name == "compact":
        from raht3dgs_tpu_torch.ops.raht_compact import raht_forward_compact

        return raht_forward_compact
    if name == "scan":
        from raht3dgs_tpu_torch.ops.raht_scan import raht_forward_scan

        return raht_forward_scan
    if name == "span":
        from raht3dgs_tpu_torch.ops.raht_span import raht_forward_span

        return raht_forward_span
    raise ValueError(f"unknown RAHT impl {name!r}")
