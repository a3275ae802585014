"""Inter-depth predicted RAHT ("PRAHT") — transform-domain prediction.

Beyond-reference attribute-coding mode in the spirit of MPEG G-PCC's
upsampled-prediction RAHT: the plain transform's exact symbol LAYOUT is
kept (the RA-GFT stream order — DC first, then detail groups from the
coarsest octree depth to the finest, ``ops/reorder.py``), but each depth
group's AC coefficients are replaced by prediction RESIDUALS against an
upsampled prediction computed from the previous (coarser) depth's
*reconstructed* cell means. Inter-cell correlation that plain RAHT can
only exploit within a butterfly pair is removed across cell boundaries,
which is where most of the rate in smooth content lives.

Closed loop, coarse to fine (both sides run the identical numpy code, so
the loop is bitwise self-consistent; the stream records the transform
dtype so a float32 encode replays in float32):

1. depth 0: quantize the DC (``sqrt(W_root) * mean``), reconstruct the
   root mean.
2. depth d: predict every depth-``d`` cell mean from the reconstructed
   depth-``d-1`` means (weighted average of the parent and its occupied
   face/edge neighbors toward the child's octant — weights 4/2/1, the
   classic upsampling stencil). Transform the TRUE cell means and the
   predicted means with the same 3 sub-level butterflies (grouped by
   parent; identical weights, hence identical butterfly constants); code
   ``quantize(AC_true - AC_pred)``. Reconstruct children by the inverse
   butterfly from the parent's reconstructed DC and
   ``AC_pred + dequantize(q)``; descend.

Per depth the encoder picks prediction ON/OFF by a codelength proxy and
signals the choice in a bitmask (prediction helps only while inter-cell
correlation survives at that scale; on noise-like detail the residual
can cost MORE than the plain coefficient). Bit ``d-1`` set = depth ``d``
coded residuals.

Because group ``d`` symbols occupy the same stream positions as the
plain transform's, everything layered on the stream layout keeps
working: prefix (progressive) decode — skipped symbols reconstruct as
zero residuals, i.e. the decoder returns the PREDICTION cascade, a
smoother preview than plain truncation — LOD cuts
(``pipeline.lod_prefix_count``), chunked entropy payloads, and both
entropy coders.

Counterpart of ``raht3dgs_tpu/ops/praht.py``, carried almost verbatim
(the module is numpy only): its outputs are bitwise the JAX package's for
the same numpy inputs. The reference has no prediction of any kind; this
mode is opt-in (``AttributeCodec(predict=True)``, ``encode_ply
--predict``) and is a host-side path like the entropy and geometry coders.
The closed loop runs through ``native/praht.cpp`` (``backend="native"``,
the default; a failed build raises) or through the numpy statements below
(``backend="python"``), which are the spec the library replays bit for
bit. ``ops/praht_device.py`` is the card's encoder for the same format.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = [
    "BACKENDS",
    "cell_pyramid",
    "praht_encode",
    "praht_decode",
    "praht_plan",
    "praht_true_coeffs",
    "predict_means",
    "PrahtPlan",
]

_U3 = np.uint64(3)
_U7 = np.uint64(7)


def _decode_axes_np(codes: np.ndarray, depth: int) -> np.ndarray:
    """(M, 3) integer positions from Morton codes, digit = z + 2y + 4x
    (mirrors ``ops/morton.py`` on host; real codes of every depth, 21
    included, fit int64)."""
    c = codes.astype(np.int64)
    V = np.zeros((c.shape[0], 3), dtype=np.int64)
    for i in range(depth):
        V[:, 2] |= ((c >> (3 * i)) & 1) << i
        V[:, 1] |= ((c >> (3 * i + 1)) & 1) << i
        V[:, 0] |= ((c >> (3 * i + 2)) & 1) << i
    return V


def cell_pyramid(
    codes: np.ndarray,
    weights: np.ndarray,
    depth: int,
    attrs: Optional[np.ndarray] = None,
    fdtype=np.float64,
) -> List[tuple]:
    """Per-depth occupied-cell stats, leaves up.

    Returns ``pyr[d] = (codes_d (M_d,) uint64, W_d (M_d,) fdtype,
    S_d (M_d, D) fdtype | None)`` for ``d = 0..depth`` — sorted unique
    depth-``d`` cell codes, total cell weights, and (when ``attrs`` is
    given) weighted attribute sums. The decoder builds the same pyramid
    without attrs; both sides reduce in the same (sequential reduceat)
    order, so the weights — and every butterfly constant derived from
    them — are bitwise identical.
    """
    codes = np.asarray(codes)
    cur = codes.astype(np.uint64)
    W = np.asarray(weights, dtype=fdtype)
    S = None
    if attrs is not None:
        S = np.asarray(attrs, dtype=fdtype) * W[:, None]
    pyr: List[tuple] = [None] * (depth + 1)
    pyr[depth] = (cur, W, S)
    for d in range(depth - 1, -1, -1):
        pc = pyr[d + 1][0] >> _U3
        firsts = np.concatenate([[True], pc[1:] != pc[:-1]])
        idx = np.nonzero(firsts)[0]
        W_d = np.add.reduceat(pyr[d + 1][1], idx)
        S_d = (
            None
            if S is None
            else np.add.reduceat(pyr[d + 1][2], idx, axis=0)
        )
        pyr[d] = (pc[idx], W_d, S_d)
    return pyr


def _pairings(codes_d: np.ndarray, W_d: np.ndarray, fdtype):
    """The 3 sub-level butterfly schedules for one octree depth.

    Pairs adjacent active cells whose codes agree above bit ``j`` for
    ``j = 1..3`` — cells of different parents differ above bit 3, so
    pairing stays within a parent group, exactly the global transform's
    levels ``3*(depth-d)+1..+3`` restricted to this depth
    (``ops/raht.py:_level_mask`` semantics). Returns
    ``(pairs, idx_surv)``: per sub-level ``(i0, i1, a, b)`` with the
    butterfly constants already computed from the (chained) weights, and
    the surviving slots — one per parent, in parent order.
    """
    M = codes_d.shape[0]
    w = W_d.astype(fdtype).copy()
    # int32 indices: fancy-index gathers/scatters only (no arithmetic), so
    # the narrower dtype cannot change any float result; it halves the
    # footprint of plans held across a sweep
    idx = np.arange(M, dtype=np.int32)
    pairs = []
    for j in (1, 2, 3):
        cj = codes_d[idx]
        if cj.size <= 1:
            break
        eq = ((cj[:-1] ^ cj[1:]) >> np.uint64(j)) == 0
        if not eq.any():
            continue
        flag = np.append(eq, False)
        right = np.concatenate([[False], eq])
        i0 = idx[flag]
        i1 = idx[right]
        w0 = w[i0]
        w1 = w[i1]
        tot = w0 + w1
        a = np.sqrt(w0 / tot)[:, None]
        b = np.sqrt(w1 / tot)[:, None]
        pairs.append((i0, i1, a, b))
        w[i0] = tot
        idx = idx[~right]
    return pairs, idx


def _forward3(T: np.ndarray, pairs) -> np.ndarray:
    """Apply one depth's butterflies (values in, coefficients out)."""
    T = T.copy()
    for i0, i1, a, b in pairs:
        x0 = T[i0].copy()
        x1 = T[i1].copy()
        T[i0] = a * x0 + b * x1
        T[i1] = -b * x0 + a * x1
    return T


def _inverse3(T: np.ndarray, pairs) -> np.ndarray:
    """Invert one depth's butterflies (coefficients in, values out)."""
    C = T.copy()
    for i0, i1, a, b in reversed(pairs):
        t0 = C[i0].copy()
        t1 = C[i1].copy()
        C[i0] = a * t0 - b * t1
        C[i1] = b * t0 + a * t1
    return C


def _axis_masks(d: int):
    """Per-axis Morton bit masks at depth ``d`` (digit = z + 2y + 4x, so
    z occupies bits 3i, y bits 3i+1, x bits 3i+2)."""
    mz = 0
    for i in range(d):
        mz |= 1 << (3 * i)
    return (np.uint64(mz << 2), np.uint64(mz << 1), np.uint64(mz))


def _step_axis(codes, mask, low, direction):
    """One-voxel Morton neighbor step along one axis, per-row direction.

    The classic masked-arithmetic trick: filling the OTHER axes' bits
    with ones makes the increment's carry propagate only through this
    axis's (interleaved) bits; decrement borrows within the masked value
    directly. Exactly equals decode->±1->re-encode, without the per-bit
    loops. Returns ``(stepped_codes, valid)`` — invalid rows (grid
    boundary) carry wrapped garbage and MUST be gated by ``valid``.
    """
    m = codes & mask
    pos = direction > 0
    inc = (((codes | ~mask) + low) & mask) | (codes & ~mask)
    dec = ((m - low) & mask) | (codes & ~mask)
    valid = np.where(pos, m != mask, m != 0)
    return np.where(pos, inc, dec), valid


def predict_means(
    parent_codes: np.ndarray,
    parent_means: np.ndarray,
    child_codes: np.ndarray,
    d: int,
    fdtype=np.float64,
) -> np.ndarray:
    """Upsample depth-``d-1`` reconstructed cell means to depth-``d`` cells.

    For each child cell: a weighted average of its parent (weight 4) and
    the occupied face (2) / edge (1) neighbor parents displaced toward
    the child's octant — the G-PCC-style inverse-distance ladder (the
    corner neighbor adds ~0 and one more lookup pass; omitted).
    Unoccupied or out-of-grid neighbors drop out of the average; the
    parent itself always exists, so the denominator is never zero.
    ``parent_codes`` must be sorted (they are a pyramid level).

    FROZEN replay contract (CLAUDE.md): the stencil order (face x, y, z,
    then edges xy, xz, yz) and the per-hit accumulation order are part
    of the closed loop — streams decode by re-running this exact
    function.
    """
    pc = child_codes >> _U3
    o = (child_codes & _U7).astype(np.int64)
    j = np.searchsorted(parent_codes, pc)
    num = 4.0 * parent_means[j]
    den = np.full(child_codes.shape[0], 4.0, dtype=fdtype)
    if d >= 2:
        masks = _axis_masks(d - 1)
        lows = (np.uint64(1) << np.uint64(2), np.uint64(1) << np.uint64(1),
                np.uint64(1))
        # octant digit = z + 2y + 4x -> step direction per axis
        dirs = (o[:, None] >> np.asarray([2, 1, 0])) & 1
        face, fvalid = zip(*(
            _step_axis(pc, masks[ax], lows[ax], dirs[:, ax])
            for ax in range(3)
        ))
        cands = [(face[ax], fvalid[ax], 2.0) for ax in range(3)]
        for a, b in ((0, 1), (0, 2), (1, 2)):
            s, v = _step_axis(face[a], masks[b], lows[b], dirs[:, b])
            cands.append((s, v & fvalid[a], 1.0))
        last = len(parent_codes) - 1
        for ncode, valid, wt in cands:
            k = np.minimum(np.searchsorted(parent_codes, ncode), last)
            hit = valid & (parent_codes[k] == ncode)
            num[hit] += wt * parent_means[k[hit]]
            den[hit] += wt
    return (num / den[:, None]).astype(fdtype, copy=False)


class _LevelPlan(NamedTuple):
    """Step-independent per-depth schedule of the predicted loop.

    Everything here depends only on geometry (codes + weights): the
    butterfly pairings with their constants, the survivor/AC partition,
    the weight square-roots, and the prediction STENCIL — the base parent
    index per child plus, per neighbor candidate (in the FROZEN stencil
    order: face x, y, z, then edges xy, xz, yz), the children it hits and
    the parent it contributes. Replaying the stencil is bitwise identical
    to re-deriving it (:func:`predict_means` accumulates the same values
    in the same order), so plans are pure reuse, not a format change.
    """

    n_ac: int
    pairs: tuple          # ((i0, i1, a, b), ...) sub-level butterflies
    idx_surv: np.ndarray  # (M_parents,) int32 surviving slots
    is_ac: np.ndarray     # (M_d,) bool
    sq: np.ndarray        # (M_d, 1) sqrt cell weights, fdtype
    sqrt_pw: np.ndarray   # (M_parents, 1) sqrt parent weights, fdtype
    base_j: np.ndarray    # (M_d,) int32 parent index per child
    cands: tuple          # ((hit_rows int32, parent_idx int32, wt), ...)
    # Native-kernel layouts (pure re-indexings of pairs/cands — the numpy
    # fields above stay the spec; None when the plan predates them):
    csr: Optional[tuple] = None   # (off int64 (M+1,), k int32, wt fdtype)
    flat: Optional[tuple] = None  # (sub_off int64, i0, i1, a, b) flattened
    ac_rows: Optional[np.ndarray] = None      # flatnonzero(is_ac) int32
    sq_flat: Optional[np.ndarray] = None      # sq.ravel() contiguous
    sqrt_pw_flat: Optional[np.ndarray] = None  # sqrt_pw.ravel() contiguous


class PrahtPlan(NamedTuple):
    """Step-independent per-frame precomputation for the predicted loop.

    The closed loop runs once per (frame, step); its geometry work — the
    cell pyramid, the butterfly schedules, and the 9-candidate neighbor
    stencil — is step-independent and dominates the wall-clock of a
    step. Encode sweeps, rate searches, and decode reuse one plan across
    every step. ``pyramid[d] = (codes_d, W_d, reduceat_idx)`` (idx is
    None at the leaf level).
    """

    depth: int
    fdtype: type
    pyramid: tuple
    levels: tuple         # levels[d-1] = _LevelPlan for depth d
    sqrt_w0: np.ndarray   # (1, 1) sqrt root weight column


def _stencil(parent_codes: np.ndarray, child_codes: np.ndarray, d: int):
    """Precompute :func:`predict_means`'s geometry: the base parent index
    and the per-candidate (hit_rows, parent_idx, weight) lists, in the
    frozen stencil order."""
    pc = child_codes >> _U3
    o = (child_codes & _U7).astype(np.int64)
    base_j = np.searchsorted(parent_codes, pc).astype(np.int32)
    cands_out = []
    if d >= 2:
        masks = _axis_masks(d - 1)
        lows = (np.uint64(1) << np.uint64(2), np.uint64(1) << np.uint64(1),
                np.uint64(1))
        dirs = (o[:, None] >> np.asarray([2, 1, 0])) & 1
        face, fvalid = zip(*(
            _step_axis(pc, masks[ax], lows[ax], dirs[:, ax])
            for ax in range(3)
        ))
        cands = [(face[ax], fvalid[ax], 2.0) for ax in range(3)]
        for a, b in ((0, 1), (0, 2), (1, 2)):
            s, v = _step_axis(face[a], masks[b], lows[b], dirs[:, b])
            cands.append((s, v & fvalid[a], 1.0))
        last = len(parent_codes) - 1
        for ncode, valid, wt in cands:
            k = np.minimum(np.searchsorted(parent_codes, ncode), last)
            hit = valid & (parent_codes[k] == ncode)
            rows = np.flatnonzero(hit).astype(np.int32)
            cands_out.append((rows, k[rows].astype(np.int32), wt))
    return base_j, tuple(cands_out)


def _predict_from_stencil(lv: _LevelPlan, parent_means: np.ndarray,
                          fdtype) -> np.ndarray:
    """Replay of :func:`predict_means` from a precomputed stencil —
    identical accumulation values and order, hence bitwise equal."""
    num = 4.0 * parent_means[lv.base_j]
    den = np.full(num.shape[0], 4.0, dtype=fdtype)
    for rows, k, wt in lv.cands:
        num[rows] += wt * parent_means[k]
        den[rows] += wt
    return (num / den[:, None]).astype(fdtype, copy=False)


# ---------------------------------------------------------------------------
# Backend dispatch. native/praht.cpp replicates the numpy spec BITWISE (see
# its header); the caller names the backend, and a failed build raises.
BACKENDS = ("native", "python")


def _native(backend: str):
    """The native module for ``backend="native"``, None for the numpy spec."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown praht backend {backend!r} (choose from {BACKENDS})")
    if backend == "python":
        return None
    from raht3dgs_tpu_torch.ops import _praht_native

    return _praht_native


def _predict_lv(lv: _LevelPlan, parent_means: np.ndarray,
                fdtype, backend: str) -> np.ndarray:
    nat = _native(backend)
    if nat is not None:
        return nat.predict(lv.base_j, *lv.csr, parent_means, fdtype)
    return _predict_from_stencil(lv, parent_means, fdtype)


def _forward_lv(lv: _LevelPlan, T: np.ndarray, backend: str) -> np.ndarray:
    nat = _native(backend)
    if nat is not None:
        return nat.butterfly(T, *lv.flat, inverse=False)
    return _forward3(T, lv.pairs)


def _inverse_lv(lv: _LevelPlan, T: np.ndarray, backend: str) -> np.ndarray:
    nat = _native(backend)
    if nat is not None:
        return nat.butterfly(T, *lv.flat, inverse=True)
    return _inverse3(T, lv.pairs)


def _reconstruct_lv(lv: _LevelPlan, deq, T_pred, m_prev: np.ndarray,
                    fdtype, D: int, backend: str) -> np.ndarray:
    """One depth's reconstruct step: T assembly (AC rows from ``deq``
    [+ prediction], survivor rows from the parent means), inverse
    butterflies, divide by sq. The numpy statements below are the frozen
    spec; the native kernel replays them bitwise in one pass."""
    nat = _native(backend)
    if nat is not None:
        return nat.decode_step(lv, deq if deq is not None else
                               np.zeros((0, D), dtype=fdtype),
                               T_pred, m_prev, fdtype)
    T_rec = np.zeros((lv.is_ac.shape[0], D), dtype=fdtype)
    if deq is not None and lv.n_ac:
        T_rec[lv.is_ac] = (T_pred[lv.is_ac] + deq) if T_pred is not None \
            else deq
    T_rec[lv.idx_surv] = lv.sqrt_pw * m_prev
    return _inverse_lv(lv, T_rec, backend) / lv.sq


def _csr_from_cands(M: int, cands: tuple, fdtype) -> tuple:
    """Per-row candidate lists in the frozen stencil order (the native
    predict kernel walks rows outer / candidates inner — each row's
    accumulation chain is unchanged)."""
    counts = np.zeros(M, dtype=np.int64)
    for rows, _, _ in cands:
        counts[rows] += 1
    off = np.zeros(M + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    kk = np.empty(int(off[-1]), dtype=np.int32)
    ww = np.empty(int(off[-1]), dtype=fdtype)
    cursor = off[:-1].copy()
    for rows, k, wt in cands:
        pos = cursor[rows]
        kk[pos] = k
        ww[pos] = wt
        cursor[rows] += 1
    return off, kk, ww


def _flat_from_pairs(pairs: tuple, fdtype) -> tuple:
    """Concatenated sub-level pair arrays for the native butterfly."""
    n = len(pairs)
    sub_off = np.zeros(n + 1, dtype=np.int64)
    for s, (i0, _, _, _) in enumerate(pairs):
        sub_off[s + 1] = sub_off[s] + i0.shape[0]
    if n == 0:
        z = np.zeros(0, dtype=np.int32)
        return sub_off, z, z.copy(), np.zeros(0, fdtype), np.zeros(0, fdtype)
    i0f = np.ascontiguousarray(np.concatenate([p[0] for p in pairs]))
    i1f = np.ascontiguousarray(np.concatenate([p[1] for p in pairs]))
    af = np.ascontiguousarray(
        np.concatenate([p[2].ravel() for p in pairs]).astype(fdtype,
                                                             copy=False))
    bf = np.ascontiguousarray(
        np.concatenate([p[3].ravel() for p in pairs]).astype(fdtype,
                                                             copy=False))
    return sub_off, i0f, i1f, af, bf


def praht_plan(
    codes: np.ndarray,
    weights: np.ndarray,
    depth: int,
    fdtype=np.float64,
    backend: str = "native",
) -> PrahtPlan:
    """Build the step-independent plan for one frame's predicted loop. The
    plan holds the numpy spec's fields and the native layouts alike, so
    either backend runs it; ``backend`` picks who builds the stencil (the
    same integers either way)."""
    codes = np.asarray(codes)
    if codes.ndim != 1:
        raise ValueError("codes must be 1-D sorted unique Morton codes")
    cur = codes.astype(np.uint64)
    W = np.asarray(weights, dtype=fdtype)
    pyramid: List[tuple] = [None] * (depth + 1)
    pyramid[depth] = (cur, W, None)
    for d in range(depth - 1, -1, -1):
        pc = pyramid[d + 1][0] >> _U3
        firsts = np.concatenate([[True], pc[1:] != pc[:-1]])
        idx = np.nonzero(firsts)[0]
        pyramid[d] = (pc[idx], np.add.reduceat(pyramid[d + 1][1], idx), idx)
    levels = []
    for d in range(1, depth + 1):
        codes_d, W_d, _ = pyramid[d]
        pcodes, pW, _ = pyramid[d - 1]
        pairs, idx_surv = _pairings(codes_d, W_d, fdtype)
        is_ac = np.ones(codes_d.shape[0], dtype=bool)
        is_ac[idx_surv] = False
        nat = _native(backend)
        if nat is not None:
            # one C pass; exact integer match of _stencil + its CSR form
            base_j, cands, csr = nat.stencil(pcodes, codes_d, d, fdtype)
        else:
            base_j, cands = _stencil(pcodes, codes_d, d)
            csr = _csr_from_cands(codes_d.shape[0], cands, fdtype)
        sq_col = np.sqrt(W_d)[:, None].astype(fdtype, copy=False)
        pw_col = np.sqrt(pW)[:, None]
        # the flat arrays are the single copy of the butterfly schedule;
        # the numpy-spec `pairs` become VIEWS into them (same values,
        # ~half the plan footprint — plans are cached across sweeps)
        flat = _flat_from_pairs(tuple(pairs), fdtype)
        sub_off, i0f, i1f, af, bf = flat
        pairs = tuple(
            (i0f[sub_off[s]:sub_off[s + 1]],
             i1f[sub_off[s]:sub_off[s + 1]],
             af[sub_off[s]:sub_off[s + 1], None],
             bf[sub_off[s]:sub_off[s + 1], None])
            for s in range(len(pairs)))
        levels.append(_LevelPlan(
            n_ac=codes_d.shape[0] - pcodes.shape[0],
            pairs=pairs,
            idx_surv=np.asarray(idx_surv, dtype=np.int32),
            is_ac=is_ac,
            sq=sq_col,
            sqrt_pw=pw_col,
            base_j=base_j,
            cands=cands,
            csr=csr,
            flat=flat,
            ac_rows=np.flatnonzero(is_ac).astype(np.int32),
            sq_flat=np.ascontiguousarray(sq_col.ravel()),
            sqrt_pw_flat=np.ascontiguousarray(
                pw_col.ravel().astype(fdtype, copy=False)),
        ))
    return PrahtPlan(
        depth=depth,
        fdtype=fdtype,
        pyramid=tuple(pyramid),
        levels=tuple(levels),
        sqrt_w0=np.sqrt(pyramid[0][1])[:, None],
    )


def praht_true_coeffs(plan: PrahtPlan, attrs: np.ndarray,
                      backend: str = "native"):
    """Per-frame true-signal coefficients (step-independent encode half).

    Returns ``(dc (1, D), tt_ac)`` where ``tt_ac[d-1]`` holds depth
    ``d``'s true AC coefficients — exactly the ``_forward3(m_true * sq,
    pairs)[is_ac]`` rows the per-step loop quantizes. One call serves a
    whole sweep/rate search of the same frame.
    """
    fdtype = plan.fdtype
    S = np.asarray(attrs, dtype=fdtype) * plan.pyramid[plan.depth][1][:, None]
    sums: List[np.ndarray] = [None] * (plan.depth + 1)
    sums[plan.depth] = S
    for d in range(plan.depth - 1, -1, -1):
        sums[d] = np.add.reduceat(sums[d + 1], plan.pyramid[d][2], axis=0)
    dc = plan.sqrt_w0 * (sums[0] / plan.pyramid[0][1][:, None])
    tt_ac = []
    for d in range(1, plan.depth + 1):
        lv = plan.levels[d - 1]
        if lv.n_ac:
            m_true = sums[d] / plan.pyramid[d][1][:, None]
            tt_ac.append(_forward_lv(lv, m_true * lv.sq, backend)[lv.is_ac])
        else:
            tt_ac.append(None)
    return dc, tt_ac


def _quantize_np(x, steps, quant_mode, f):
    if quant_mode == "deadzone":
        return (np.sign(x) * np.floor(np.abs(x) / steps + f)).astype(
            np.int32
        )
    return np.floor(x / steps + 0.5).astype(np.int32)


def _dequantize_np(q, steps, quant_mode, delta, fdtype):
    qf = q.astype(fdtype)
    if quant_mode == "deadzone":
        return (np.sign(qf) * (np.abs(qf) + delta) * steps).astype(
            fdtype, copy=False
        )
    return (qf * steps).astype(fdtype, copy=False)


def _codelen_proxy(q: np.ndarray) -> float:
    """Exp-Golomb-style codelength proxy for the per-depth predict
    decision: ``sum(2*floor(log2(|q|+1)) + 1)`` bits. Monotone in
    magnitude and run-friendly like both real coders; only the encoder
    evaluates it (the choice is signalled), so it need not match either
    coder's exact cost."""
    a = np.abs(q, dtype=np.int64)
    return float(np.sum(2 * np.floor(np.log2(a + 1.0)) + 1.0))


def _steps_row(steps: np.ndarray, fdtype) -> np.ndarray:
    """(1,) or (D,) steps as a broadcastable row in the loop dtype."""
    s = np.atleast_1d(np.asarray(steps, dtype=fdtype))
    return s[None, :] if s.shape[0] > 1 else s


def _check_plan(plan: PrahtPlan, codes: np.ndarray, weights, depth: int,
                fdtype) -> None:
    """A stale plan silently decodes the WRONG stream — verify it matches
    this frame's geometry (O(N) compares, negligible vs the loop)."""
    if plan.depth != depth or plan.fdtype != fdtype:
        raise ValueError(
            f"plan was built for depth={plan.depth}/"
            f"{np.dtype(plan.fdtype).name}, frame needs depth={depth}/"
            f"{np.dtype(fdtype).name}"
        )
    leaf_codes, leaf_w, _ = plan.pyramid[depth]
    if leaf_codes.shape[0] != codes.shape[0] or not np.array_equal(
        leaf_codes, codes.astype(np.uint64)
    ):
        raise ValueError("plan does not match this frame's Morton codes")
    if not np.array_equal(leaf_w, np.asarray(weights, dtype=fdtype)):
        raise ValueError("plan does not match this frame's weights")


def praht_encode(
    codes: np.ndarray,
    attrs: np.ndarray,
    weights: np.ndarray,
    depth: int,
    steps,
    *,
    quant_mode: str = "mid",
    quant_f: float = 0.3,
    rec_delta: float = 0.12,
    fdtype=np.float64,
    adaptive: bool = True,
    plan: Optional[PrahtPlan] = None,
    true_coeffs=None,
    backend: str = "native",
) -> Tuple[np.ndarray, int, np.ndarray]:
    """Closed-loop predicted-RAHT encode of one frame (real rows only).

    ``codes`` are sorted unique leaf Morton codes; ``steps`` is scalar or
    per-channel. Returns ``(sym (D, N) int32 in stream order,
    predict_mask, rec (N, D) leaf reconstruction)`` — ``sym`` feeds
    :func:`models.pipeline.build_entropy_stream` directly, and ``rec``
    is the decoder's exact output (same loop), so drivers get distortion
    for free. ``adaptive=False`` forces prediction on at every depth.

    ``plan`` (:func:`praht_plan`) and ``true_coeffs``
    (:func:`praht_true_coeffs`) are the step-independent halves — pass
    them to amortize sweeps and rate searches; outputs are bitwise
    identical with or without them (the plan replays the exact same
    float ops in the same order), and with either ``backend``.
    """
    codes = np.asarray(codes)
    if codes.ndim != 1:
        raise ValueError("codes must be 1-D sorted unique Morton codes")
    N, D = np.asarray(attrs).shape
    if plan is None:
        plan = praht_plan(codes, weights, depth, fdtype=fdtype, backend=backend)
    else:
        _check_plan(plan, codes, weights, depth, fdtype)
    if true_coeffs is None:
        true_coeffs = praht_true_coeffs(plan, attrs, backend)
    dc, tt_ac = true_coeffs
    st = _steps_row(steps, fdtype)
    f = fdtype(quant_f)
    dl = fdtype(rec_delta)

    sym = np.zeros((N, D), dtype=np.int32)
    # DC: sqrt(W_root) * root mean — the survivor coefficient
    qdc = _quantize_np(dc, st, quant_mode, f)
    sym[0] = qdc[0]
    m_rec = _dequantize_np(qdc, st, quant_mode, dl, fdtype) / plan.sqrt_w0
    pos = 1
    mask = 0
    rec: Optional[np.ndarray] = None
    for d in range(1, depth + 1):
        lv = plan.levels[d - 1]
        n_ac = lv.n_ac
        T_pred = None
        use_pred = False
        if n_ac:
            pred = _predict_lv(lv, m_rec, fdtype, backend)
            T_pred = _forward_lv(lv, pred * lv.sq, backend)
            q_pred = _quantize_np(
                tt_ac[d - 1] - T_pred[lv.is_ac], st, quant_mode, f
            )
            if adaptive:
                q_plain = _quantize_np(tt_ac[d - 1], st, quant_mode, f)
                use_pred = _codelen_proxy(q_pred) < _codelen_proxy(
                    q_plain
                )
                q = q_pred if use_pred else q_plain
            else:
                use_pred = True
                q = q_pred
            sym[pos : pos + n_ac] = q
            pos += n_ac
        if use_pred:
            mask |= 1 << (d - 1)
        deq = (_dequantize_np(q, st, quant_mode, dl, fdtype)
               if n_ac else None)
        m_rec = _reconstruct_lv(lv, deq, T_pred if use_pred else None,
                                m_rec, fdtype, D, backend)
        if d == depth:
            rec = m_rec
    if pos != N:
        raise AssertionError(
            f"praht symbol walk covered {pos} of {N} coefficients"
        )
    return np.ascontiguousarray(sym.T), mask, np.asarray(rec)


def praht_decode(
    sym_T: np.ndarray,
    codes: np.ndarray,
    weights: np.ndarray,
    depth: int,
    steps,
    *,
    predict_mask: int,
    quant_mode: str = "mid",
    quant_f: float = 0.3,
    rec_delta: float = 0.12,
    fdtype=np.float64,
    lod_depth: Optional[int] = None,
    plan: Optional[PrahtPlan] = None,
    backend: str = "native",
):
    """Decode a predicted-RAHT stream's (D, N) symbol matrix.

    ``sym_T`` may be prefix-filled (progressive decode): symbols past the
    decoded prefix are zero residuals, so the reconstruction falls back
    to the prediction cascade — a smooth coarse-to-fine preview.
    ``lod_depth`` stops the descent early and returns
    ``(cell_codes (M,) uint64, means (M, D), cell_weights (M,))`` at
    that depth; otherwise returns the (N, D) leaf attributes. Mirrors
    :func:`praht_encode` exactly (identical numpy ops — the closed loop
    is bitwise shared). ``plan`` reuses :func:`praht_plan`'s
    step-independent geometry (bitwise-identical output).
    """
    codes = np.asarray(codes)
    D, N = np.asarray(sym_T).shape
    if N != codes.shape[0]:
        raise ValueError(
            f"symbol matrix covers {N} coefficients for {codes.shape[0]} "
            "voxels"
        )
    target = depth if lod_depth is None else lod_depth
    if not 0 <= target <= depth:
        raise ValueError(f"lod_depth must be in [0, {depth}], got {lod_depth}")
    if plan is None:
        plan = praht_plan(codes, weights, depth, fdtype=fdtype, backend=backend)
    else:
        _check_plan(plan, codes, weights, depth, fdtype)
    st = _steps_row(steps, fdtype)
    dl = fdtype(rec_delta)
    sym = np.ascontiguousarray(np.asarray(sym_T).T)

    m_rec = _dequantize_np(
        sym[0][None, :], st, quant_mode, dl, fdtype
    ) / plan.sqrt_w0
    pos = 1
    for d in range(1, target + 1):
        lv = plan.levels[d - 1]
        n_ac = lv.n_ac
        deq = T_pred = None
        if n_ac:
            deq = _dequantize_np(
                sym[pos : pos + n_ac], st, quant_mode, dl, fdtype
            )
            if predict_mask >> (d - 1) & 1:
                pred = _predict_lv(lv, m_rec, fdtype, backend)
                T_pred = _forward_lv(lv, pred * lv.sq, backend)
            pos += n_ac
        m_rec = _reconstruct_lv(lv, deq, T_pred, m_rec, fdtype, D, backend)
    if lod_depth is None:
        return np.asarray(m_rec)
    return plan.pyramid[target][0], np.asarray(m_rec), np.asarray(
        plan.pyramid[target][1]
    )
