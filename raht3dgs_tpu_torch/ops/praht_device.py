"""Device encoder for inter-depth predicted RAHT.

Counterpart of ``raht3dgs_tpu/ops/praht_device.py``. The host closed loop
(``ops/praht.py``) is the FROZEN decode spec: any stream, from any
encoder, must reconstruct by replaying that exact numpy code. This module
is a *throughput encoder* for the same stream format: the whole per-step
closed loop (predict -> butterflies -> quantize -> reconstruct, coarse to
fine) runs as PyTorch ops on the padded sorted-code layout the rest of the
codec uses, a Python loop over the octree depths whose decisions stay on
the device (``torch.where`` on the per-depth predict bit), so a step
crosses to the host once, for its symbols and its mask.

Why an encoder-side implementation cannot break the format: every
decoder-visible decision is SIGNALLED (the per-depth predict mask, the
symbols themselves); the decoder never re-derives encoder state. A device
encoder whose float ops differ from host numpy by an ulp emits symbols
that differ (rarely, at quantization-boundary ties) from the host
encoder's, but the stream still decodes exactly, by construction. The
ops mirror the host loop's in the same order (stencil lanes accumulated
in the frozen order, identical butterfly expressions, an exact integer
codelength proxy), and the square roots are correctly rounded on every
device (``ops/raht.py:ieee_sqrt``).

Key correspondences with the host loop (``ops/praht.py``):

- True coefficients: the host transforms per-depth cell MEANS scaled by
  ``sqrt(cell weight)``; by the RAHT invariant this equals the standard
  forward transform of ``attributes * sqrt(leaf weights)``, which the
  caller passes in (``models/pipeline.py`` runs its span transform). The
  two may differ in the last ulp, which can flip a quantization tie.
- Per-depth butterflies: octree depth ``d`` owns butterfly levels
  ``3*(depth-d)+1 .. +3`` of the global level loop; the active set before
  level ``j`` is ``drop == 0 | drop >= j``, from the transform's one
  structure pass.
- Prediction stencil: the 4/2/1 parent/face/edge upsampling
  (``ops/praht.py:predict_means``), precomputed per frame as gather slots
  and weights. Neighbour lookup is a leaf-code prefix search: the first
  leaf >= ``ncode << 3*(depth-d+1)`` is the neighbour parent's first-leaf
  slot iff its prefix matches and it is a real voxel. The stencil's
  integer arithmetic runs in int64 for both code tiers (the JAX package
  lets int32 targets wrap; the hits, and so the weights and the hit
  slots, are the same).

``praht_device_decode`` is NON-NORMATIVE (its only caller will be the
serving path): the frozen host loop decodes every stream of the codec.
Depth <= 20 (the int32 and int64 code tiers) only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raht3dgs_tpu_torch.ops.raht import (
    _butterfly_ab,
    _level_mask,
    _neighbor_pack,
    _succ_active,
    ieee_sqrt,
    num_levels,
)

__all__ = ["PrahtDevicePlan", "praht_device_plan", "praht_device_encode",
           "praht_device_decode", "MAX_DEPTH"]

MAX_DEPTH = 20  # the int32 and int64 code tiers

# stencil lanes, in the host loop's FROZEN accumulation order: parent,
# face x/y/z, edge xy/xz/yz (ops/praht.py:predict_means)
_LANES = 7
_LANE_WT = (4.0, 2.0, 2.0, 2.0, 1.0, 1.0, 1.0)


class PrahtDevicePlan(NamedTuple):
    """Step-independent device state for one frame's predicted loop: it
    depends only on geometry (codes and weights), so encode sweeps reuse
    one plan. All tensors live on the frame's device."""

    drop: torch.Tensor       # (N,) int32 global merge levels (transform structure)
    subtree_w: torch.Tensor  # (N,) merge-time subtree weights (structure)
    w_stack: torch.Tensor    # (depth+1, N) cell weights per octree depth d
    st_idx: torch.Tensor     # (depth, N, 7) int32 stencil gather slots
    st_wt: torch.Tensor      # (depth, N, 7) stencil weights (0 = invalid lane)


def _axis_masks_full(depth: int):
    """Per-axis Morton bit masks over the FULL depth (the host uses exact
    per-level masks and validity bits; here carries land above the
    ``3*(d-1)``-bit parent grid, where the prefix-hit test rejects them)."""
    mz = 0
    for i in range(depth):
        mz |= 1 << (3 * i)
    return (mz << 2, mz << 1, mz)


def _step_axis_dev(codes, mask: int, low: int, direction):
    """Masked-arithmetic one-cell Morton step (``ops/praht.py:_step_axis``
    semantics; validity by the caller's prefix-hit test, see
    :func:`_axis_masks_full`). ``codes`` are int64."""
    m = codes & mask
    pos = direction > 0
    inc = (((codes | ~mask) + low) & mask) | (codes & ~mask)
    dec = ((m - low) & mask) | (codes & ~mask)
    # steps past either edge of the axis land above the parent grid (no
    # prefix hit), but a decrement at the origin can wrap to low bits
    # inside it, so m == 0 decrements are gated explicitly
    valid = pos | (m != 0)
    return torch.where(pos, inc, dec), valid


def _check_depth(depth: int) -> None:
    if depth > MAX_DEPTH:
        raise ValueError(
            "device predicted RAHT covers the int32/int64 code tiers "
            f"(depth <= {MAX_DEPTH}), got depth={depth}; use the host encoder")


def praht_device_plan(codes: torch.Tensor, weights: torch.Tensor, depth: int,
                      drop: torch.Tensor, subtree_w: torch.Tensor) -> PrahtDevicePlan:
    """Build the step-independent device plan from the frame's padded
    sorted codes and weights and the transform's global structure."""
    _check_depth(depth)
    if codes.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"codes must be int32 or int64, got {codes.dtype}")
    N = codes.shape[0]
    dev = codes.device
    fdtype = weights.dtype

    # w_stack: cell weights at every octree depth, bottom-up. Exactly the
    # forward merge additions (left += right at its drop level), so the
    # values are bitwise the host pyramid's sums for integer multiplicities.
    w_stack = torch.zeros((depth + 1, N), dtype=fdtype, device=dev)
    w = weights.clone()
    for t in range(depth):
        w_stack[depth - t] = w
        for jj in range(1, 4):
            j = 3 * t + jj
            act = (drop == 0) | (drop >= j)
            succ = _succ_active(act)
            succ_c = succ.clamp(max=N - 1).long()
            is_left = act & (succ < N) & (drop[succ_c] == j)
            w = torch.where(is_left, w + w[succ_c], w)
    w_stack[0] = w

    # the prediction stencil per depth d = 1..depth
    c64 = codes.to(torch.int64)
    masks = _axis_masks_full(depth)
    lows = (4, 2, 1)
    real = weights > 0
    shifts = torch.tensor([2, 1, 0], dtype=torch.int64, device=dev)
    lane_wt = torch.tensor(_LANE_WT, dtype=fdtype, device=dev)
    st_idx = torch.zeros((depth, N, _LANES), dtype=torch.int32, device=dev)
    st_wt = torch.zeros((depth, N, _LANES), dtype=fdtype, device=dev)
    for d in range(1, depth + 1):
        shift = 3 * (depth - d)
        cc = c64 >> shift
        pc = cc >> 3
        dirs = ((cc & 7)[:, None] >> shifts) & 1
        face, fvalid = [], []
        for ax in range(3):
            s, v = _step_axis_dev(pc, masks[ax], lows[ax], dirs[:, ax])
            face.append(s)
            fvalid.append(v)
        cands = [(pc, torch.ones_like(real))]
        cands += [(face[ax], fvalid[ax]) for ax in range(3)]
        for a, b in ((0, 1), (0, 2), (1, 2)):
            s, v = _step_axis_dev(face[a], masks[b], lows[b], dirs[:, b])
            cands.append((s, v & fvalid[a]))
        leaf_shift = shift + 3
        ncode = torch.stack([c for c, _ in cands], dim=1)
        valid = torch.stack([v for _, v in cands], dim=1)
        k = torch.searchsorted(c64, ncode << leaf_shift).clamp(max=N - 1)
        hit = valid & ((c64[k] >> leaf_shift) == ncode) & real[k]
        st_idx[d - 1] = k.to(torch.int32)
        st_wt[d - 1] = lane_wt[None, :] * hit.to(fdtype)
    return PrahtDevicePlan(drop=drop, subtree_w=subtree_w.to(fdtype), w_stack=w_stack,
                           st_idx=st_idx, st_wt=st_wt)


def _quant_dev(x, st, quant_mode: str, f):
    if quant_mode == "deadzone":
        return (torch.sign(x) * torch.floor(torch.abs(x) / st + f)).to(torch.int32)
    return torch.floor(x / st + 0.5).to(torch.int32)


def _dequant_dev(q, st, quant_mode: str, delta, fdtype):
    qf = q.to(fdtype)
    if quant_mode == "deadzone":
        return torch.sign(qf) * (torch.abs(qf) + delta) * st
    return qf * st


def _codelen_bits(q: torch.Tensor) -> torch.Tensor:
    """Exact per-symbol Exp-Golomb proxy bits, ``2*floor(log2(|q|+1))+1``
    as int64 (``ops/praht.py:_codelen_proxy``): ``frexp`` of the float64
    ``|q|+1``, exact for every int32 symbol (|q| + 1 <= 2^31 < 2^53)."""
    t = q.to(torch.int64).abs() + 1
    e = torch.frexp(t.to(torch.float64)).exponent.to(torch.int64)
    return 2 * (e - 1) + 1


def _predict_lanes(plan: PrahtDevicePlan, d: int, m: torch.Tensor) -> torch.Tensor:
    """Upsampled prediction from the precomputed stencil, accumulated in
    the host loop's frozen lane order."""
    idx = plan.st_idx[d - 1].long()
    wt = plan.st_wt[d - 1]
    num = wt[:, 0:1] * m[idx[:, 0]]
    den = wt[:, 0]
    for lane in range(1, _LANES):
        num = num + wt[:, lane:lane + 1] * m[idx[:, lane]]
        den = den + wt[:, lane]
    return num / torch.where(den > 0, den, torch.ones_like(den))[:, None]


def _forward_depth(codes, drop, levels: int, T, w, shift: int):
    """One octree depth's 3 forward sub-levels (the host ``_forward3`` with
    constants from the chained weights). Returns ``(T_out, sub)``, ``sub``
    holding each sub-level's pairing for the inverse replay."""
    N = codes.shape[0]
    sub = []
    for jj in range(1, 4):
        j = shift + jj
        act = (drop == 0) | (drop >= j)
        mask = _level_mask(j, levels)
        succ, pr, (sT, sw, scode), (pT, pw, pcode) = _neighbor_pack(act, codes, [T, w])
        left = act & (succ < N) & (((codes ^ scode) & mask) == 0)
        right = act & (pr >= 0) & (((codes ^ pcode) & mask) == 0) & ~left
        touched = left | right
        wp = torch.where(left, sw, pw)
        w0_ = torch.where(left, w, wp)
        w1_ = torch.where(left, wp, w)
        a, b = _butterfly_ab(w0_, w1_)
        L = left[:, None]
        Tp = torch.where(L, sT, pT)
        x0 = torch.where(L, T, Tp)
        x1 = torch.where(L, Tp, T)
        lo = a[:, None] * x0 + b[:, None] * x1
        hi = -b[:, None] * x0 + a[:, None] * x1
        T = torch.where(touched[:, None], torch.where(L, lo, hi), T)
        w = torch.where(touched, w0_ + w1_, w)
        sub.append((left, right, succ.clamp(max=N - 1).long(), pr.clamp(min=0).long(), a, b))
    return T, sub


def _inverse_depth(C, sub):
    """Replay one depth's inverse butterflies with the forward's own
    constants (bitwise the host ``_inverse3`` pair math)."""
    for left, right, succ_c, pred_c, a, b in reversed(sub):
        L = left[:, None]
        Cp = torch.where(L, C[succ_c], C[pred_c])
        t0 = torch.where(L, C, Cp)
        t1 = torch.where(L, Cp, C)
        lo = a[:, None] * t0 - b[:, None] * t1
        hi = b[:, None] * t0 + a[:, None] * t1
        C = torch.where(L, lo, torch.where(right[:, None], hi, C))
    return C


def _steps_row(steps: torch.Tensor, fdtype, device) -> torch.Tensor:
    st = torch.atleast_1d(torch.as_tensor(steps)).to(device=device, dtype=fdtype)
    return st[None, :] if st.shape[0] > 1 else st


def _depth_masks(plan: PrahtDevicePlan, real, depth: int, d: int):
    """(alive_d, alive_p, ac, sq_d, sq_p) of octree depth ``d``: the slots
    holding a depth-``d`` cell, a depth-``d-1`` cell, a depth-``d`` AC
    coefficient, and the square roots of their cell weights."""
    drop = plan.drop
    shift = 3 * (depth - d)
    alive_d = real & ((drop == 0) | (drop > shift))
    alive_p = real & ((drop == 0) | (drop > shift + 3))
    ac = real & (drop > shift) & (drop <= shift + 3)
    return alive_d, alive_p, ac, ieee_sqrt(plan.w_stack[d]), ieee_sqrt(plan.w_stack[d - 1])


def _reconstruct(m, deq, use_pred, T_pred, sub, masks):
    """One depth's reconstruction from its dequantized symbols: AC slots
    from ``deq`` (plus the prediction where it was used), survivor slots
    from the parent means, the inverse butterflies, divide by sq."""
    alive_d, alive_p, ac, sq_d, sq_p = masks
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    C = torch.where(ac[:, None], torch.where(use_pred, T_pred + deq, deq), zero)
    C = torch.where(alive_p[:, None], sq_p[:, None] * m, C)
    C = _inverse_depth(C, sub)
    m_next = C / torch.where(sq_d > 0, sq_d, torch.ones_like(sq_d))[:, None]
    return torch.where(alive_d[:, None], m_next, zero)


def praht_device_encode(plan: PrahtDevicePlan, codes: torch.Tensor, weights: torch.Tensor,
                        tt: torch.Tensor, depth: int, steps: torch.Tensor, *,
                        quant_mode: str = "mid", qf: float = 0.3,
                        rec_delta: float = 0.12, adaptive: bool = True):
    """Closed-loop predicted-RAHT encode of one step, on the frame's device.

    ``tt`` is the (N, D) true-coefficient matrix in padded slot layout,
    the standard forward transform of ``attributes * sqrt(weights)``.
    ``steps`` is (1,) or (D,). Returns ``(sym (N, D) int32 slot layout,
    predict_mask int64 device scalar, rec (N, D))``; gather ``sym`` with
    the frame's pads-last RA-GFT order to obtain the stream symbol matrix
    (the host encoder's layout). Nothing crosses to the host."""
    _check_depth(depth)
    N, D = tt.shape
    fdtype = tt.dtype
    dev = tt.device
    levels = num_levels(depth, N)
    st = _steps_row(steps, fdtype, dev)
    f = torch.tensor(qf, dtype=fdtype, device=dev)
    dl = torch.tensor(rec_delta, dtype=fdtype, device=dev)
    real = weights > 0

    # DC: the root survivor's coefficient sits at slot 0
    q0 = _quant_dev(tt[0][None, :], st, quant_mode, f)
    sqrt_w0 = ieee_sqrt(plan.w_stack[0, :1])
    m = torch.zeros((N, D), dtype=fdtype, device=dev)
    m[0] = (_dequant_dev(q0, st, quant_mode, dl, fdtype) / sqrt_w0)[0]
    sym = torch.zeros((N, D), dtype=torch.int32, device=dev)
    sym[0] = q0[0]
    maskbits = torch.zeros((), dtype=torch.int64, device=dev)
    q_plain = _quant_dev(tt, st, quant_mode, f)
    bits_plain = _codelen_bits(q_plain) if adaptive else None
    for d in range(1, depth + 1):
        masks = _depth_masks(plan, real, depth, d)
        ac, sq_d = masks[2], masks[3]
        # prediction (host accumulation order), then the depth's forward
        # butterflies of pred * sq
        pred = _predict_lanes(plan, d, m)
        T_pred, sub = _forward_depth(codes, plan.drop, levels, pred * sq_d[:, None],
                                     plan.w_stack[d], 3 * (depth - d))
        # quantize: residual against plain, the per-depth decision by the
        # exact codelength proxy (encoder-only; strict <, as the host)
        q_pred = _quant_dev(tt - T_pred, st, quant_mode, f)
        if adaptive:
            acD = ac[:, None]
            proxy_p = torch.where(acD, _codelen_bits(q_pred), 0).sum()
            proxy_0 = torch.where(acD, bits_plain, 0).sum()
            use_pred = proxy_p < proxy_0
        else:
            use_pred = torch.ones((), dtype=torch.bool, device=dev)
        q = torch.where(use_pred, q_pred, q_plain)
        sym = torch.where(ac[:, None], q, sym)
        maskbits = maskbits | (use_pred.to(torch.int64) << (d - 1))
        deq = _dequant_dev(q, st, quant_mode, dl, fdtype)
        m = _reconstruct(m, deq, use_pred, T_pred, sub, masks)
    rec = torch.where(real[:, None], m, torch.zeros((), dtype=fdtype, device=dev))
    return sym, maskbits, rec


def praht_device_decode(plan: PrahtDevicePlan, codes: torch.Tensor, weights: torch.Tensor,
                        sym: torch.Tensor, predict_mask: int, depth: int,
                        steps: torch.Tensor, *, quant_mode: str = "mid",
                        rec_delta: float = 0.12, fdtype=torch.float32) -> torch.Tensor:
    """NON-NORMATIVE device decode of a predicted-RAHT symbol matrix.

    The frozen host loop (``ops/praht.py:praht_decode``) is the decode
    spec; this reconstructs the same stream to within float ulps. Use it
    only where ulp-level drift is harmless and the reconstruction stays
    out of closed loops (the serving path, where attributes feed a
    renderer). ``sym`` is the (N, D) int32 symbol matrix in padded SLOT
    layout (the stream matrix through the inverse pads-last RA-GFT
    permutation); ``predict_mask`` the stream's signalled per-depth bits.
    Returns the (N, D) reconstruction (pad rows zero)."""
    _check_depth(depth)
    N, D = sym.shape
    dev = sym.device
    levels = num_levels(depth, N)
    st = _steps_row(steps, fdtype, dev)
    dl = torch.tensor(rec_delta, dtype=fdtype, device=dev)
    real = weights > 0

    sqrt_w0 = ieee_sqrt(plan.w_stack[0, :1])
    m = torch.zeros((N, D), dtype=fdtype, device=dev)
    m[0] = (_dequant_dev(sym[0][None, :], st, quant_mode, dl, fdtype) / sqrt_w0)[0]
    deq = _dequant_dev(sym, st, quant_mode, dl, fdtype)
    for d in range(1, depth + 1):
        masks = _depth_masks(plan, real, depth, d)
        use_pred = bool((int(predict_mask) >> (d - 1)) & 1)
        pred = _predict_lanes(plan, d, m)
        T_pred, sub = _forward_depth(codes, plan.drop, levels, pred * masks[3][:, None],
                                     plan.w_stack[d], 3 * (depth - d))
        use = torch.tensor(use_pred, device=dev)
        m = _reconstruct(m, deq, use, T_pred, sub, masks)
    return torch.where(real[:, None], m, torch.zeros((), dtype=fdtype, device=dev))
