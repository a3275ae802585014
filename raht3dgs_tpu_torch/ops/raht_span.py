"""Closed-form ("span") RAHT: no per-level loop.

Counterpart of ``raht3dgs_tpu/ops/raht_span.py`` (the math is laid out in
its docstring and in docs/span_math.md). For sorted unique codes the merge
tree is closed-form: ``B[i] = msb(code[i-1] ^ code[i])``, node ``i`` drops
at ``B[i] + 1``, its partner is ``prev_ge[i]`` and its span ends at
``next_ge[i]``; every butterfly input is a difference of prefix sums.

Float32 prefix sums run in compensated double-single arithmetic through
the CUDA kernel of ``ops/ds_scan.py`` (its plain version on the CPU);
float64 keeps plain float64 sums. ``RAHT3DGS_SPAN_SUMS`` (read once, at
import, as in the JAX package) selects the float32 sums: ``ds`` (the
default) and ``dsflat`` both take the port's kernel, whose association is
its own (the JAX package's two associations are XLA scans; the port's
float32 stream is held by its own pins and the cross-package gate of
ROADMAP item 6), and ``f64`` runs plain float64 ``torch.cumsum`` s, as the
JAX package runs them outside any kernel. ``RAHT3DGS_PALLAS`` picks TPU
kernels that the port's scan replaces, so it is not read. Every float64
expression here is written as single IEEE operations (no fused
multiply-add, no ``addcmul``), so the port's CPU and CUDA runs give the
same float64 bits wherever the prefix sums are exact.

Codes of every tier work here, the flipped int64 form of depth 21 included
(``ops/morton.py``): the XOR of two codes is the JAX package's, and
:func:`_msb` reads bit 63 of a negative one.

``RAHT3DGS_NEARESTGE=tiered`` (read at import) swaps the flat nearest->=
scans for :func:`_nearest_ge_tiered`, bitwise the same outputs;
``RAHT3DGS_SPAN_INVERSE=fill`` (read per call) swaps the pointer-doubling
inverse for the interval-sum :func:`_raht_inverse_span_fill`.

The ``*_batched`` forms at the end run a (B, N, ...) stack of equally
padded frames, as the JAX package's batched codec ``jax.vmap``s these
functions (``parallel/sharding.py``): the same operations in the same
order for every frame, with the f32 prefix packs through the scan kernel's
batched entry (one launch per stack), so frame b's result equals the
single-frame function's on frame b bit for bit. The single-frame functions
never call them.
"""

from __future__ import annotations

import math
import os

import torch

from raht3dgs_tpu_torch.ops.ds_scan import (
    ds_cumsum,
    ds_cumsum_batched,
    ds_prefix_pack,
    ds_prefix_pack_batched,
)
from raht3dgs_tpu_torch.ops.raht import (
    RahtForwardResult,
    RahtStructure,
    _butterfly_ab,
    ieee_sqrt,
    num_levels,
)

# flat|tiered and ds|dsflat|f64, read once at import as in the JAX package
_NGE_MODE = os.environ.get("RAHT3DGS_NEARESTGE", "flat")
_SUM_MODE = os.environ.get("RAHT3DGS_SPAN_SUMS", "ds")


def _use_ds(fdtype) -> bool:
    """float32 prefix sums through the double-single scan (else float64)."""
    return fdtype == torch.float32 and _SUM_MODE != "f64"


def _msb(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Position of the most significant set bit (x > 0), exact, int32.

    The float32 exponent is the first guess, corrected where rounding
    carried up to the next power of two. Inputs wider than 31 bits are
    split into 32-bit halves in int64; a negative input (bit 63 set: a
    real code next to a pad in the flipped depth-21 form) has its high half
    masked to 32 bits, so its msb reads 63."""

    def msb32(v):  # int32/int64 tensor, 0 <= v < 2^32
        vf = v.to(torch.float32)
        e = ((vf.view(torch.int32) >> 23) & 0xFF) - 127
        e = torch.clamp(e, 0, 31).to(torch.int32)
        carry = (v >> e.to(v.dtype)) == 0  # rounded up: true msb is e - 1
        return torch.where(carry, e - 1, e)

    if bits <= 31:
        return msb32(x & 0x7FFFFFFF)
    x = x.to(torch.int64)
    hi = (x >> 32) & 0xFFFFFFFF
    lo = x & 0xFFFFFFFF
    return torch.where(hi > 0, 32 + msb32(hi), msb32(lo)).to(torch.int32)


def _nearest_ge_flat(B: torch.Tensor, n_vals: int, W: torch.Tensor = None,
                     idx0: int = 0, n_all: int = None, w_total: torch.Tensor = None):
    """prev_ge[i] (previous j with B[j] >= B[i], else -1) and next_ge[i]
    (next k with B[k] >= B[i], else N), batched over the value alphabet
    with one (V, N) cummax / reverse cummin; each element then reads its
    own threshold row.

    With ``W`` (an ``(N+1,)`` nondecreasing prefix array) also returns
    ``W[max(prev_ge, 0)]`` and ``W[next_ge]``, propagated as values through
    the same scans (bitwise equal to the gathers, by monotonicity).

    A run of rows of a longer array (``parallel/sp_span.py``): ``B`` its
    rows from global row ``idx0`` of ``n_all``, ``W`` its ``W[idx0 ..]``
    rows and ``w_total`` the array's ``W[n_all]``; outputs are global, -1 /
    ``n_all`` / 0 / ``w_total`` where the run holds no such row."""
    N = B.shape[0]
    n_all = N if n_all is None else n_all
    dev = B.device
    idx = torch.arange(idx0, idx0 + N, dtype=torch.int32, device=dev)
    vals = torch.arange(n_vals, dtype=B.dtype, device=dev)
    ge = B[None, :] >= vals[:, None]                       # (V, N)
    neg1 = torch.full((), -1, dtype=torch.int32, device=dev)
    nfill = torch.full((), n_all, dtype=torch.int32, device=dev)
    last = torch.cummax(torch.where(ge, idx, neg1), dim=1).values
    nxt = torch.cummin(torch.where(ge, idx, nfill).flip(1), dim=1).values.flip(1)
    # strictly-before / strictly-after: shift the inclusive scans by one
    # and read each element's own row B[i]
    rows = B.to(torch.int64)[None, :]
    last_excl = torch.cat([torch.full((n_vals, 1), -1, dtype=torch.int32, device=dev),
                           last[:, :-1]], dim=1)
    next_excl = torch.cat([nxt[:, 1:], nfill.expand(n_vals, 1)], dim=1)
    prev_ge = torch.gather(last_excl, 0, rows)[0]
    next_ge = torch.gather(next_excl, 0, rows)[0]
    if W is None:
        return prev_ge, next_ge
    Wrow = W[:N]
    w_total = W[N] if w_total is None else w_total
    zero = torch.zeros((), dtype=W.dtype, device=dev)
    lastW = torch.cummax(torch.where(ge, Wrow[None, :], zero), dim=1).values
    nxtW = torch.cummin(torch.where(ge, Wrow[None, :], w_total).flip(1),
                        dim=1).values.flip(1)
    lastW_excl = torch.cat([torch.zeros((n_vals, 1), dtype=W.dtype, device=dev),
                            lastW[:, :-1]], dim=1)
    nextW_excl = torch.cat([nxtW[:, 1:], w_total.expand(n_vals, 1)], dim=1)
    w_prev = torch.gather(lastW_excl, 0, rows)[0]
    w_next = torch.gather(nextW_excl, 0, rows)[0]
    return prev_ge, next_ge, w_prev, w_next


def _nge_stage(Bc, orig, lo: int, hi: int, n_slots: int, Wc=None, w_total=None):
    """Nearest->= scans for threshold rows ``[lo, hi)`` over one compact
    subsequence: ``Bc (M,)`` its B values, ``orig (M,)`` their original
    positions (padding rows: ``Bc == -1``, ``orig == n_slots``, never a
    winner). The scans carry ``orig``, so outputs are global positions.
    Valid only where ``lo <= Bc < hi`` (0 elsewhere)."""
    dev = Bc.device
    nrows = hi - lo
    vals = torch.arange(lo, hi, dtype=Bc.dtype, device=dev)
    ge = Bc[None, :] >= vals[:, None]                       # (V, M)
    neg1 = torch.full((), -1, dtype=torch.int32, device=dev)
    nfill = torch.full((), n_slots, dtype=torch.int32, device=dev)
    last = torch.cummax(torch.where(ge, orig, neg1), dim=1).values
    nxt = torch.cummin(torch.where(ge, orig, nfill).flip(1), dim=1).values.flip(1)
    in_range = (Bc >= lo) & (Bc < hi)
    rows = torch.clamp(Bc.to(torch.int64) - lo, 0, nrows - 1)[None, :]

    def before(m, fill):   # strictly before: shift right, ``fill`` first
        return torch.cat([fill.expand(nrows, 1), m[:, :-1]], dim=1)

    def after(m, fill):    # strictly after: shift left, ``fill`` last
        return torch.cat([m[:, 1:], fill.expand(nrows, 1)], dim=1)

    def own_row(excl):     # each element's own threshold row, 0 out of range
        return torch.where(in_range, torch.gather(excl, 0, rows)[0],
                           torch.zeros((), dtype=excl.dtype, device=dev))

    prev_ge = own_row(before(last, neg1))
    next_ge = own_row(after(nxt, nfill))
    if Wc is None:
        return prev_ge, next_ge
    zero = torch.zeros((), dtype=Wc.dtype, device=dev)
    lastW = torch.cummax(torch.where(ge, Wc[None, :], zero), dim=1).values
    nxtW = torch.cummin(torch.where(ge, Wc[None, :], w_total).flip(1), dim=1).values.flip(1)
    return prev_ge, next_ge, own_row(before(lastW, zero)), own_row(after(nxtW, w_total))


def _nge_tier_plan(N: int, n_vals: int):
    """Static tier plan ``[(lo, hi, M), ...]`` for :func:`_nearest_ge_tiered`,
    or None where tiering cannot help (small N or alphabet). Exact because
    codes are sorted and unique: the positions with ``B >= v`` number at
    most ``2^(levels - v)`` plus the row-0 sentinel, so high thresholds scan
    a short compacted subsequence. The JAX package's plan."""
    levels = n_vals - 2
    if N < 8192:
        return None
    t1 = levels - (max(N // 8, 1)).bit_length() + 1
    if t1 < 2 or t1 >= n_vals - 1:
        return None
    plan = [(0, t1, N)]
    lo = t1
    while lo < n_vals:
        bound = (1 << max(levels - lo, 0)) + 1          # +1: the sentinel row
        M = min(N, -(-bound // 256) * 256)
        if M <= 2048 or lo + 3 >= n_vals:
            plan.append((lo, n_vals, M))
            break
        plan.append((lo, lo + 3, M))
        lo += 3
    return plan


def _nearest_ge_tiered(B: torch.Tensor, n_vals: int, W: torch.Tensor = None,
                       idx0: int = 0, n_all: int = None, w_total: torch.Tensor = None):
    """:func:`_nearest_ge_flat` with its high-threshold rows scanned over
    compacted candidate subsequences (:func:`_nge_tier_plan`): bitwise the
    same outputs, since every scan selects the same elements. ``idx0``,
    ``n_all`` and ``w_total`` as there (the plan is the whole array's)."""
    N = B.shape[0]
    n_all = N if n_all is None else n_all
    plan = _nge_tier_plan(n_all, n_vals)
    if plan is None:
        return _nearest_ge_flat(B, n_vals, W, idx0, n_all, w_total)
    dev = B.device
    idx = torch.arange(idx0, idx0 + N, dtype=torch.int32, device=dev)
    Wrow = None if W is None else W[:N]
    if W is not None and w_total is None:
        w_total = W[N]

    # stage 0 over the whole array writes every output; elements of a higher
    # tier are overwritten by their own tier's scatter below
    lo0, hi0, _ = plan[0]
    out = _nge_stage(B, idx, lo0, hi0, n_all, Wrow, w_total)
    ipad = torch.cat([torch.stack(out[:2], dim=1),
                      torch.zeros((1, 2), dtype=torch.int32, device=dev)])
    wpad = None if W is None else torch.cat(
        [torch.stack(out[2:], dim=1), torch.zeros((1, 2), dtype=W.dtype, device=dev)])

    Bc, orig, Wc, Mc = B, idx, Wrow, N
    for lo, hi, M in plan[1:]:
        # compact the candidates of thresholds >= lo into M slots (the bound
        # holds them all); padding rows read the appended B=-1 / orig=N row
        mask = Bc >= lo
        pos = torch.cumsum(mask, 0, dtype=torch.int64) - 1
        sel = torch.full((M + 1,), Mc, dtype=torch.int64, device=dev)
        sel[torch.where(mask & (pos < M), pos, torch.full_like(pos, M))] = \
            torch.arange(Mc, dtype=torch.int64, device=dev)
        sel = sel[:M]
        Bc = torch.cat([Bc, torch.full((1,), -1, dtype=Bc.dtype, device=dev)])[sel]
        orig = torch.cat([orig, torch.full((1,), n_all, dtype=torch.int32, device=dev)])[sel]
        if W is not None:
            Wc = torch.cat([Wc, torch.zeros((1,), dtype=Wc.dtype, device=dev)])[sel]
        Mc = M
        out = _nge_stage(Bc, orig, lo, hi, n_all, Wc, w_total)
        tgt = torch.where((Bc >= lo) & (Bc < hi), orig - idx0,
                          torch.full_like(orig, N)).long()
        ipad[tgt] = torch.stack(out[:2], dim=1)
        if W is not None:
            wpad[tgt] = torch.stack(out[2:], dim=1)
    if W is None:
        return ipad[:N, 0], ipad[:N, 1]
    return ipad[:N, 0], ipad[:N, 1], wpad[:N, 0], wpad[:N, 1]


def _nearest_ge(B: torch.Tensor, n_vals: int, W: torch.Tensor = None):
    if _NGE_MODE == "tiered":
        return _nearest_ge_tiered(B, n_vals, W)
    return _nearest_ge_flat(B, n_vals, W)


def _span_topology(codes: torch.Tensor, depth: int, W: torch.Tensor = None):
    """Closed-form B / drop levels / prev_ge / next_ge from codes alone;
    with ``W`` also the propagated ``W[max(prev_ge, 0)]`` / ``W[next_ge]``."""
    N = codes.shape[0]
    levels = num_levels(depth, N)
    dev = codes.device
    diff = codes[1:] ^ codes[:-1]
    B = torch.cat([torch.full((1,), levels + 1, dtype=torch.int32, device=dev),
                   _msb(diff, levels).to(torch.int32)])
    drop = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                      (B[1:] + 1).to(torch.int32)])
    if W is None:
        prev_ge, next_ge = _nearest_ge(B, levels + 2)
        return drop, prev_ge, next_ge, levels, B
    prev_ge, next_ge, w_prev, w_next = _nearest_ge(B, levels + 2, W)
    return drop, prev_ge, next_ge, levels, w_prev, w_next, B


def _ds_cumsum(values_f32: torch.Tensor):
    """Compensated prefix sums along dim 0; returns (hi, lo) float32. Always
    the CUDA kernel for a CUDA tensor (its plain version on the CPU)."""
    return ds_cumsum(values_f32.contiguous())


def _two_sum(a, b):
    s = a + b
    bv = s - a
    err = (a - (s - bv)) + (b - bv)
    return s, err


def _weight_prefix(weights: torch.Tensor, fdtype):
    """Exclusive prefix sums (W[i] = sum w[:i]), length N+1, and the total.
    float32 runs the ds scan (exact for integer weights), float64 (or
    ``RAHT3DGS_SPAN_SUMS=f64``) a plain float64 cumsum."""
    if _use_ds(fdtype):
        hi, lo = _ds_cumsum(weights.to(torch.float32)[:, None])
        Wincl = (hi + lo)[:, 0]
    else:
        Wincl = torch.cumsum(weights.to(torch.float64), dim=0)
    W = torch.cat([torch.zeros((1,), dtype=Wincl.dtype, device=Wincl.device), Wincl])
    return W, Wincl[-1]


def _prefix_pack(body: torch.Tensor, use_ds: bool) -> torch.Tensor:
    """Exclusive prefix sums of ``body (N, K)`` with a leading zero row:
    (N+1, K) float64, or (N+1, 2K) float32 with [hi | lo] columns (on the
    card written by the scan kernel in place, with no copies)."""
    if use_ds:
        return ds_prefix_pack(body.to(torch.float32).contiguous())
    P = torch.cumsum(body.to(torch.float64), dim=0)
    return torch.cat([torch.zeros((1, P.shape[1]), dtype=P.dtype, device=P.device), P])


def _prefix_diff(g_hi, g_lo, h_hi, h_lo):
    """(g - h) for double-single prefixes, compensated."""
    s, e = _two_sum(g_hi, -h_hi)
    e = e + (g_lo - h_lo)
    return s + e


def _pair_weights(codes: torch.Tensor, weights: torch.Tensor, depth: int, fdtype):
    """Per-pair side weights (w0, w1, w_total) plus topology, bitwise equal
    to what :func:`raht_forward_span` derives from its fused pack: the
    pack's weight column is an independent column of the same scan, whose
    association depends on N alone. The ``weight_desc`` stream order
    depends on this encoder == decoder identity.

    Returns (drop, prev_ge, next_ge, levels, B, w0, w1, w_total)."""
    N = codes.shape[0]
    if _use_ds(fdtype):
        drop, prev_ge, next_ge, levels, B = _span_topology(codes, depth)
        P = _prefix_pack(weights.to(torch.float32)[:, None], True)
        here = P[:N]
        g_next = P[next_ge.long()]
        g_prev = P[torch.clamp(prev_ge, min=0).long()]
        w1 = _prefix_diff(g_next[:, :1], g_next[:, 1:], here[:, :1], here[:, 1:])[:, 0]
        w0 = _prefix_diff(here[:, :1], here[:, 1:], g_prev[:, :1], g_prev[:, 1:])[:, 0]
        w_total = P[N, 0] + P[N, 1]
        return drop, prev_ge, next_ge, levels, B, w0, w1, w_total
    W, w_total = _weight_prefix(weights, fdtype)
    drop, prev_ge, next_ge, levels, w_prev, w_next, B = _span_topology(codes, depth, W)
    W_here = W[:N]
    return drop, prev_ge, next_ge, levels, B, W_here - w_prev, w_next - W_here, w_total


def raht_structure_span(codes: torch.Tensor, weights: torch.Tensor,
                        depth: int) -> RahtStructure:
    """Closed-form structure pass (decoder prelude)."""
    N = codes.shape[0]
    fdtype = weights.dtype
    drop, _, _, _, _, w0, w1, w_total = _pair_weights(codes, weights, depth, fdtype)
    is0 = torch.arange(N, device=codes.device) == 0
    node_w = torch.where(is0, w_total, w0 + w1).to(fdtype)
    subtree = torch.where(is0, w_total, w1).to(fdtype)
    return RahtStructure(drop_level=drop, subtree_w=subtree, node_weights=node_w)


def _guarded_scale(sub: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sub / sqrt(w)`` where ``w > 0``, else 0 (row-wise, any leading
    dimensions)."""
    pos = w > 0
    root = ieee_sqrt(torch.where(pos, w, torch.ones_like(w)))
    return torch.where(pos[..., None], sub / root[..., None], torch.zeros_like(sub))


def raht_forward_span(codes: torch.Tensor, attributes: torch.Tensor,
                      weights: torch.Tensor, depth: int) -> RahtForwardResult:
    """Closed-form forward RAHT.

    The weight column rides the fused prefix pack; the decoder reproduces
    its values bitwise through :func:`_pair_weights`."""
    N, D = attributes.shape
    fdtype = attributes.dtype
    dev = attributes.device
    drop, prev_ge, next_ge, _, _B = _span_topology(codes, depth)
    idx = torch.arange(N, device=dev)

    use_ds = _use_ds(fdtype)
    acc_dt = torch.float32 if use_ds else torch.float64
    w_acc = weights.to(acc_dt)
    sw = ieee_sqrt(w_acc)[:, None]
    body = torch.cat([sw * attributes.to(acc_dt), w_acc[:, None]], dim=1)
    K = D + 1
    SW = _prefix_pack(body, use_ds)

    SW_here = SW[:N]
    g_next = SW[next_ge.long()]
    g_prev = SW[torch.clamp(prev_ge, min=0).long()]
    if use_ds:
        sub = _prefix_diff(g_next[:, :K], g_next[:, K:], SW_here[:, :K], SW_here[:, K:])
        sub1, w1 = sub[:, :D], sub[:, D]
        sub = _prefix_diff(SW_here[:, :K], SW_here[:, K:], g_prev[:, :K], g_prev[:, K:])
        sub0, w0 = sub[:, :D], sub[:, D]
        totals = SW[N, :K] + SW[N, K:]
        w_total = totals[D]
        total_S = totals[:D]
    else:
        sub1 = g_next[:, :D] - SW_here[:, :D]
        sub0 = SW_here[:, :D] - g_prev[:, :D]
        w1 = g_next[:, D] - SW_here[:, D]
        w0 = SW_here[:, D] - g_prev[:, D]
        w_total = SW[N, D]
        total_S = SW[N, :D]
    x1 = _guarded_scale(sub1, w1)
    x0 = _guarded_scale(sub0, w0)
    a, b = _butterfly_ab(w0, w1)
    detail = ((-b[:, None]) * x0 + a[:, None] * x1).to(fdtype)

    w_root = ieee_sqrt(torch.where(w_total > 0, w_total, torch.ones_like(w_total)))
    dc = (total_S / w_root).to(fdtype)
    T = torch.where((idx == 0)[:, None], dc[None, :], detail)

    node_w = torch.where(idx == 0, w_total, w0 + w1).to(fdtype)
    subtree = torch.where(idx == 0, w_total, w1).to(fdtype)
    return RahtForwardResult(
        coeffs=T,
        weights=node_w,
        structure=RahtStructure(drop_level=drop, subtree_w=subtree,
                                node_weights=node_w),
    )


def _raht_inverse_span_chain(coeffs: torch.Tensor, codes: torch.Tensor,
                             weights: torch.Tensor, depth: int) -> torch.Tensor:
    """Affine pointer-doubling inverse over the merge tree.

    Recomputes the structure from ``codes`` + ``weights`` (the decoder has
    both) and resolves every pair's parent-span value in
    ceil(log2(levels + 1)) doubling rounds."""
    N, D = coeffs.shape
    fdtype = coeffs.dtype
    dev = coeffs.device
    W, w_total = _weight_prefix(weights, fdtype)
    drop, prev_ge, next_ge, levels, w_prev, w_next, _B = _span_topology(codes, depth, W)
    W_here = W[:N]
    w1 = w_next - W_here
    w0 = W_here - w_prev
    idx = torch.arange(N, device=dev)
    a, b = _butterfly_ab(w0, w1)
    T64 = coeffs

    p = prev_ge
    q = next_ge
    p_c = torch.clamp(p, min=0).long()
    q_c = torch.clamp(q, max=N - 1).long()

    # next_ge rides the neighbour table as a float lane: exact for
    # N <= 2^(mantissa bits + 1)
    lane_limit = 1 << {torch.float32: 24, torch.float64: 53}[T64.dtype]
    if N > lane_limit:
        raise NotImplementedError(
            f"{T64.dtype} chain inverse supports N <= {lane_limit} slots "
            f"(got {N}): pointer lanes ride as exact float values; use "
            "float64 I/O or RAHT3DGS_SPAN_INVERSE=fill"
        )
    nf = next_ge.to(T64.dtype)
    Z = torch.cat([a[:, None].to(T64.dtype), b[:, None].to(T64.dtype), T64,
                   nf[:, None]], dim=1)
    Zp = Z[p_c]
    Zq = Z[q_c]
    a_p, b_p, T_p = Zp[:, 0], Zp[:, 1], Zp[:, 2:2 + D]
    a_q, b_q, T_q = Zq[:, 0], Zq[:, 1], Zq[:, 2:2 + D]
    # i is its left partner's final merge iff the merged span [p, q) is
    # exactly p's own subtree span [p, next_ge[p])
    last_merge = Zp[:, 2 + D] == q.to(T64.dtype)

    # Y[i] = g[i] * Y[par[i]] + d[i]
    par = torch.where(last_merge, p_c, q_c)
    g = torch.where(last_merge, b_p, a_q)
    d = torch.where(last_merge[:, None], a_p[:, None] * T_p, (-b_q)[:, None] * T_q)
    root_child = last_merge & (p == 0)
    zero = torch.zeros((), dtype=g.dtype, device=dev)
    g = torch.where(root_child, zero, g)
    d = torch.where(root_child[:, None], T64[0][None, :], d)
    is0 = idx == 0
    g = torch.where(is0, zero, g)
    d = torch.where(is0[:, None], T64[0][None, :], d)
    par = torch.where(is0, torch.zeros_like(par), par)

    # every chain ascends >= 1 level per hop and ends at node 0 (g == 0)
    steps = max(1, math.ceil(math.log2(levels + 1)))
    for _ in range(steps):
        gp = g[par]
        dp = d[par]
        d = d + g[:, None] * dp
        g = g * gp
        par = par[par]
    Y = d

    x0 = a[:, None] * Y - b[:, None] * T64
    x1 = b[:, None] * Y + a[:, None] * T64

    # leaf k: x0[k+1] when k+1 is k's right child, else x1[k]
    nxt_is_child = torch.cat([prev_ge[1:] == idx[:-1].to(prev_ge.dtype),
                              torch.zeros((1,), dtype=torch.bool, device=dev)])
    x0_next = torch.cat([x0[1:], x0[-1:]])
    out = torch.where(nxt_is_child[:, None], x0_next, x1)
    lone = is0 & ~nxt_is_child  # N == 1: the lone root is the DC itself
    out = torch.where(lone[:, None], Y, out)
    return out.to(fdtype)


def _raht_inverse_span_fill(coeffs: torch.Tensor, codes: torch.Tensor,
                            weights: torch.Tensor, depth: int) -> torch.Tensor:
    """Scan-only inverse: the orthonormal expansion as interval sums.

    The transform is orthogonal, so each leaf expands as ``sqrt(w_k)``
    times a sum of interval-constant node terms (the JAX package's
    docstring derives it):

        c_k = sqrt(w_k) * ( sum_{i: k in [p_i, i)} u_i
              + sum_{i: k in [i, q_i)} v_i + T_0 / sqrt(W_total) )
        u_i = -b_i T_i / sqrt(w0_i),   v_i = a_i T_i / sqrt(w1_i)

    At each merge level ``x`` the spans of the nodes with ``B_i == x`` are
    disjoint, so a leaf takes at most one term per level: the nearest
    position with ``B >= x`` before (v) or after (u) it, when that
    position's B equals x. Those positions come from one (V, N) ``cummax``
    and one reversed ``cummin``, the topology's own threshold rows; the
    terms are gathered and summed over V, the channels in chunks that
    bound the (V, N, D) operand. No pointer lanes: any N."""
    N, D = coeffs.shape
    fdtype = coeffs.dtype
    dev = coeffs.device
    W, w_total = _weight_prefix(weights, fdtype)
    drop, prev_ge, next_ge, levels, w_prev, w_next, B = _span_topology(codes, depth, W)
    W_here = W[:N]
    w1 = w_next - W_here
    w0 = W_here - w_prev
    a, b = _butterfly_ab(w0, w1)
    acc_dt = torch.float64 if fdtype == torch.float64 else torch.float32
    T = coeffs.to(acc_dt)

    not0 = (torch.arange(N, device=dev) != 0).to(acc_dt)[:, None]
    u = ((-b).to(acc_dt) * _inv_root(w0, acc_dt))[:, None] * T * not0
    v = (a.to(acc_dt) * _inv_root(w1, acc_dt))[:, None] * T * not0

    n_vals = levels + 2
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    vals = torch.arange(n_vals, dtype=B.dtype, device=dev)
    ge = B[None, :] >= vals[:, None]                       # (V, N)
    last = torch.cummax(torch.where(ge, idx, torch.full_like(idx, -1)), dim=1).values
    nxt = torch.cummin(torch.where(ge, idx, torch.full_like(idx, N)).flip(1),
                       dim=1).values.flip(1)
    at_v = last.clamp(min=0).long()
    at_u = nxt.clamp(max=N - 1).long()
    hit_v = (last >= 0) & (B[at_v] == vals[:, None])
    hit_u = (nxt < N) & (B[at_u] == vals[:, None])

    v_sum = _level_sums(v, at_v, hit_v)
    u_incl = _level_sums(u, at_u, hit_u)
    # u intervals [p_i, i) leave out i itself: the backward fill at k+1
    u_sum = torch.cat([u_incl[1:], torch.zeros((1, D), dtype=acc_dt, device=dev)])

    w_root = ieee_sqrt(torch.where(w_total > 0, w_total, torch.ones_like(w_total)))
    dc_term = T[0] / w_root.to(acc_dt)
    out = (v_sum + u_sum + dc_term[None, :]) * ieee_sqrt(weights.to(acc_dt))[:, None]
    return out.to(fdtype)


def _inv_root(w, acc_dt):
    """1 / sqrt(w) where w > 0, else 0."""
    pos = w > 0
    return torch.where(pos, 1.0 / ieee_sqrt(torch.where(pos, w, torch.ones_like(w))),
                       torch.zeros_like(w)).to(acc_dt)


def _level_sums(terms, at, hit):
    """``sum_v where(hit[v, k], terms[at[v, k]], 0)`` for (N', D) terms and
    (V, N) rows: the fill inverse's per-level terms of each leaf, the
    channels in chunks that bound the (V, N, D) operand."""
    n_vals, N = at.shape
    D = terms.shape[1]
    dc = max(1, min(D, (1 << 27) // max(1, n_vals * N)))
    zero = torch.zeros((), dtype=terms.dtype, device=terms.device)
    return torch.cat([torch.where(hit[..., None], terms[:, c0:c0 + dc][at], zero).sum(0)
                      for c0 in range(0, D, dc)], dim=1)


def raht_inverse_span(coeffs: torch.Tensor, codes: torch.Tensor,
                      weights: torch.Tensor, depth: int) -> torch.Tensor:
    """Closed-form inverse RAHT (decoder side of :func:`raht_forward_span`).
    ``RAHT3DGS_SPAN_INVERSE`` (read on every call, as in the JAX package)
    picks ``chain`` (the default, :func:`_raht_inverse_span_chain`) or
    ``fill`` (:func:`_raht_inverse_span_fill`, which also serves the N that
    chain's float pointer lanes refuse); both rebuild the structure from
    ``codes`` + ``weights``."""
    if os.environ.get("RAHT3DGS_SPAN_INVERSE", "chain") == "fill":
        return _raht_inverse_span_fill(coeffs, codes, weights, depth)
    return _raht_inverse_span_chain(coeffs, codes, weights, depth)


# -- batched forms: a (B, N, ...) stack of frames of one padded size ----------


def _rows_batched(P: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``P[b, idx[b, i]]`` for a (B, M, C) stack and (B, N) indices, as
    (B, N, C): one row gather over the flattened stack, each frame's
    indices offset by b * M."""
    B, M, C = P.shape
    off = torch.arange(B, dtype=torch.int64, device=idx.device)[:, None] * M
    return P.reshape(B * M, C)[(idx.long() + off).reshape(-1)].reshape(B, -1, C)


def _nearest_ge_batched(B: torch.Tensor, n_vals: int, W: torch.Tensor = None,
                        idx0: int = 0, n_all: int = None, w_total: torch.Tensor = None):
    """:func:`_nearest_ge_flat` of every row of ``B (F, N)``, one (F, V, N)
    cummax / reverse cummin; ``W`` (F, N+1), and ``idx0`` / ``n_all`` /
    ``w_total (F,)`` for a run of rows, as there."""
    F, N = B.shape
    n_all = N if n_all is None else n_all
    dev = B.device
    idx = torch.arange(idx0, idx0 + N, dtype=torch.int32, device=dev)
    vals = torch.arange(n_vals, dtype=B.dtype, device=dev)
    ge = B[:, None, :] >= vals[None, :, None]              # (F, V, N)
    neg1 = torch.full((), -1, dtype=torch.int32, device=dev)
    nfill = torch.full((), n_all, dtype=torch.int32, device=dev)
    last = torch.cummax(torch.where(ge, idx, neg1), dim=2).values
    nxt = torch.cummin(torch.where(ge, idx, nfill).flip(2), dim=2).values.flip(2)
    rows = B.to(torch.int64)[:, None, :]
    last_excl = torch.cat([torch.full((F, n_vals, 1), -1, dtype=torch.int32, device=dev),
                           last[:, :, :-1]], dim=2)
    next_excl = torch.cat([nxt[:, :, 1:], nfill.expand(F, n_vals, 1)], dim=2)
    prev_ge = torch.gather(last_excl, 1, rows)[:, 0]
    next_ge = torch.gather(next_excl, 1, rows)[:, 0]
    if W is None:
        return prev_ge, next_ge
    Wrow = W[:, None, :N]
    w_total = (W[:, N] if w_total is None else w_total)[:, None, None]
    zero = torch.zeros((), dtype=W.dtype, device=dev)
    lastW = torch.cummax(torch.where(ge, Wrow, zero), dim=2).values
    nxtW = torch.cummin(torch.where(ge, Wrow, w_total).flip(2), dim=2).values.flip(2)
    lastW_excl = torch.cat([torch.zeros((F, n_vals, 1), dtype=W.dtype, device=dev),
                            lastW[:, :, :-1]], dim=2)
    nextW_excl = torch.cat([nxtW[:, :, 1:], w_total.expand(F, n_vals, 1)], dim=2)
    w_prev = torch.gather(lastW_excl, 1, rows)[:, 0]
    w_next = torch.gather(nextW_excl, 1, rows)[:, 0]
    return prev_ge, next_ge, w_prev, w_next


def _span_topology_batched(codes: torch.Tensor, depth: int, W: torch.Tensor = None):
    """:func:`_span_topology` of every frame of ``codes (F, N)``; row 0 of
    each frame starts its own span."""
    F, N = codes.shape
    levels = num_levels(depth, N)
    dev = codes.device
    diff = codes[:, 1:] ^ codes[:, :-1]
    B = torch.cat([torch.full((F, 1), levels + 1, dtype=torch.int32, device=dev),
                   _msb(diff, levels).to(torch.int32)], dim=1)
    drop = torch.cat([torch.zeros((F, 1), dtype=torch.int32, device=dev),
                      (B[:, 1:] + 1).to(torch.int32)], dim=1)
    if W is None:
        prev_ge, next_ge = _nearest_ge_batched(B, levels + 2)
        return drop, prev_ge, next_ge, levels, B
    prev_ge, next_ge, w_prev, w_next = _nearest_ge_batched(B, levels + 2, W)
    return drop, prev_ge, next_ge, levels, w_prev, w_next, B


def _weight_prefix_batched(weights: torch.Tensor, fdtype):
    """:func:`_weight_prefix` of every frame of ``weights (F, N)``: (F, N+1)
    and the (F,) totals. float32 through the scan kernel's batched entry;
    float64 the single-frame cumsum of each frame (a cumsum over the stack
    may associate otherwise on the card)."""
    if _use_ds(fdtype):
        hi, lo = ds_cumsum_batched(weights.to(torch.float32)[..., None].contiguous())
        Wincl = (hi + lo)[..., 0]
    else:
        Wincl = torch.stack([torch.cumsum(w, dim=0) for w in weights.to(torch.float64)])
    W = torch.cat([torch.zeros((Wincl.shape[0], 1), dtype=Wincl.dtype,
                               device=Wincl.device), Wincl], dim=1)
    return W, Wincl[:, -1]


def _prefix_pack_batched(body: torch.Tensor, use_ds: bool) -> torch.Tensor:
    """:func:`_prefix_pack` of every frame of ``body (F, N, K)``: (F, N+1, K)
    float64 (the single-frame cumsum of each frame, as in
    :func:`_weight_prefix_batched`), or (F, N+1, 2K) float32 written by the
    batched scan entry."""
    if use_ds:
        return ds_prefix_pack_batched(body.to(torch.float32).contiguous())
    P = torch.stack([torch.cumsum(b, dim=0) for b in body.to(torch.float64)])
    return torch.cat([P.new_zeros((P.shape[0], 1, P.shape[2])), P], dim=1)


def _pair_weights_from_pack(here, g_next, g_prev):
    """(w0, w1) of every row from the weight column's ds pack: its own row
    and its rows at next_ge and max(prev_ge, 0)."""
    w1 = _prefix_diff(g_next[..., :1], g_next[..., 1:], here[..., :1], here[..., 1:])[..., 0]
    w0 = _prefix_diff(here[..., :1], here[..., 1:], g_prev[..., :1], g_prev[..., 1:])[..., 0]
    return w0, w1


def _pair_weights_batched(codes: torch.Tensor, weights: torch.Tensor, depth: int,
                          fdtype):
    """:func:`_pair_weights` of every frame of a (F, N) stack."""
    N = codes.shape[1]
    if _use_ds(fdtype):
        drop, prev_ge, next_ge, levels, B = _span_topology_batched(codes, depth)
        P = _prefix_pack_batched(weights.to(torch.float32)[..., None], True)
        w0, w1 = _pair_weights_from_pack(P[:, :N], _rows_batched(P, next_ge),
                                         _rows_batched(P, torch.clamp(prev_ge, min=0)))
        w_total = P[:, N, 0] + P[:, N, 1]
        return drop, prev_ge, next_ge, levels, B, w0, w1, w_total
    W, w_total = _weight_prefix_batched(weights, fdtype)
    drop, prev_ge, next_ge, levels, w_prev, w_next, B = _span_topology_batched(codes, depth, W)
    W_here = W[:, :N]
    return drop, prev_ge, next_ge, levels, B, W_here - w_prev, w_next - W_here, w_total


def raht_structure_span_batched(codes: torch.Tensor, weights: torch.Tensor,
                                depth: int) -> RahtStructure:
    """:func:`raht_structure_span` of every frame: (F, N) fields."""
    N = codes.shape[1]
    fdtype = weights.dtype
    drop, _, _, _, _, w0, w1, w_total = _pair_weights_batched(codes, weights, depth, fdtype)
    is0 = torch.arange(N, device=codes.device) == 0
    return _structure_rows(drop, w0, w1, w_total, is0, fdtype)


def _structure_rows(drop, w0, w1, w_total, root, fdtype) -> RahtStructure:
    """The structure of (F, N) rows from their pair weights; ``root`` marks
    row 0 (the DC row, which takes the (F,) total ``w_total``), or None for
    rows without it."""
    if root is None:
        return RahtStructure(drop_level=drop, subtree_w=w1.to(fdtype),
                             node_weights=(w0 + w1).to(fdtype))
    node_w = torch.where(root, w_total[:, None], w0 + w1).to(fdtype)
    subtree = torch.where(root, w_total[:, None], w1).to(fdtype)
    return RahtStructure(drop_level=drop, subtree_w=subtree, node_weights=node_w)


def raht_forward_span_batched(codes: torch.Tensor, attributes: torch.Tensor,
                              weights: torch.Tensor, depth: int) -> RahtForwardResult:
    """:func:`raht_forward_span` of every frame of ``codes (F, N)``,
    ``attributes (F, N, D)``, ``weights (F, N)``: one fused prefix pack for
    the whole stack."""
    F, N, D = attributes.shape
    fdtype = attributes.dtype
    dev = attributes.device
    drop, prev_ge, next_ge, _, _B = _span_topology_batched(codes, depth)
    idx = torch.arange(N, device=dev)

    use_ds = _use_ds(fdtype)
    acc_dt = torch.float32 if use_ds else torch.float64
    w_acc = weights.to(acc_dt)
    sw = ieee_sqrt(w_acc)[..., None]
    body = torch.cat([sw * attributes.to(acc_dt), w_acc[..., None]], dim=2)
    SW = _prefix_pack_batched(body, use_ds)

    T, structure = _forward_rows(SW[:, :N], _rows_batched(SW, next_ge),
                                 _rows_batched(SW, torch.clamp(prev_ge, min=0)),
                                 SW[:, N], idx == 0, drop, D, use_ds, fdtype)
    return RahtForwardResult(coeffs=T, weights=structure.node_weights, structure=structure)


def _forward_rows(SW_here, g_next, g_prev, total, root, drop, D: int, use_ds: bool,
                  fdtype):
    """The forward's arithmetic on (F, N) rows, from the fused pack's row of
    each, its rows at next_ge and max(prev_ge, 0), and the pack's last row
    ``total (F, C)``: (coefficients (F, N, D), structure). ``root`` marks
    row 0 (the DC), or is None for rows without it (``total`` unused)."""
    K = D + 1
    if use_ds:
        sub = _prefix_diff(g_next[..., :K], g_next[..., K:], SW_here[..., :K], SW_here[..., K:])
        sub1, w1 = sub[..., :D], sub[..., D]
        sub = _prefix_diff(SW_here[..., :K], SW_here[..., K:], g_prev[..., :K], g_prev[..., K:])
        sub0, w0 = sub[..., :D], sub[..., D]
    else:
        sub1 = g_next[..., :D] - SW_here[..., :D]
        sub0 = SW_here[..., :D] - g_prev[..., :D]
        w1 = g_next[..., D] - SW_here[..., D]
        w0 = SW_here[..., D] - g_prev[..., D]
    x1 = _guarded_scale(sub1, w1)
    x0 = _guarded_scale(sub0, w0)
    a, b = _butterfly_ab(w0, w1)
    detail = ((-b[..., None]) * x0 + a[..., None] * x1).to(fdtype)
    if root is None:
        return detail, _structure_rows(drop, w0, w1, None, None, fdtype)
    totals = total[:, :K] + total[:, K:] if use_ds else total
    w_total = totals[:, D]
    total_S = totals[:, :D]
    w_root = ieee_sqrt(torch.where(w_total > 0, w_total, torch.ones_like(w_total)))
    dc = (total_S / w_root[:, None]).to(fdtype)
    T = torch.where(root[..., None], dc[:, None, :], detail)
    return T, _structure_rows(drop, w0, w1, w_total, root, fdtype)


def raht_inverse_span_batched(coeffs: torch.Tensor, codes: torch.Tensor,
                              weights: torch.Tensor, depth: int) -> torch.Tensor:
    """:func:`raht_inverse_span` of every frame of ``coeffs (F, N, D)``;
    returns (F, N, D). The pointer-doubling chain runs the stack at once;
    ``RAHT3DGS_SPAN_INVERSE=fill`` runs the fill inverse frame by frame."""
    if os.environ.get("RAHT3DGS_SPAN_INVERSE", "chain") == "fill":
        return torch.stack([_raht_inverse_span_fill(c, k, w, depth)
                            for c, k, w in zip(coeffs, codes, weights)])
    F, N, D = coeffs.shape
    fdtype = coeffs.dtype
    dev = coeffs.device
    W, _ = _weight_prefix_batched(weights, fdtype)
    drop, prev_ge, next_ge, levels, w_prev, w_next, _B = _span_topology_batched(codes, depth, W)
    W_here = W[:, :N]
    w1 = w_next - W_here
    w0 = W_here - w_prev
    idx = torch.arange(N, device=dev)
    a, b = _butterfly_ab(w0, w1)
    T64 = coeffs

    p = prev_ge
    q = next_ge
    p_c = torch.clamp(p, min=0).long()
    q_c = torch.clamp(q, max=N - 1).long()
    lane_limit = 1 << {torch.float32: 24, torch.float64: 53}[T64.dtype]
    if N > lane_limit:
        raise NotImplementedError(
            f"{T64.dtype} chain inverse supports N <= {lane_limit} slots "
            f"(got {N}): pointer lanes ride as exact float values; use "
            "float64 I/O"
        )
    Z = _chain_lanes(a, b, T64, next_ge)
    is0 = idx == 0
    par, g, d = _chain_links(_rows_batched(Z, p_c), _rows_batched(Z, q_c), p, q, p_c, q_c,
                             T64[:, :1, :], is0)
    for _ in range(_chain_rounds(levels)):
        g, d, par = _chain_round(g, d, par, torch.gather(g, 1, par), _rows_batched(d, par),
                                 torch.gather(par, 1, par))
    Y = d

    x0, x1 = _chain_halves(a, b, Y, T64)
    nxt_is_child = torch.cat([prev_ge[:, 1:] == idx[:-1].to(prev_ge.dtype),
                              torch.zeros((F, 1), dtype=torch.bool, device=dev)], dim=1)
    x0_next = torch.cat([x0[:, 1:], x0[:, -1:]], dim=1)
    return _chain_leaves(x0_next, x1, Y, nxt_is_child, is0).to(fdtype)


def _chain_lanes(a, b, T64, next_ge):
    """The (F, N, D + 3) rows a chain link reads at p and q: a, b, the
    coefficients and next_ge as an exact float lane."""
    return torch.cat([a[..., None].to(T64.dtype), b[..., None].to(T64.dtype), T64,
                      next_ge.to(T64.dtype)[..., None]], dim=2)


def _chain_links(Zp, Zq, p, q, p_c, q_c, dc, root):
    """Each row's link Y[i] = g[i] * Y[par[i]] + d[i] from its lanes at
    max(p, 0) and min(q, N - 1); ``dc (F, 1, D)`` the frame's DC row,
    ``root`` the rows that are row 0 (or all False)."""
    D = dc.shape[2]
    a_p, b_p, T_p = Zp[..., 0], Zp[..., 1], Zp[..., 2:2 + D]
    a_q, b_q, T_q = Zq[..., 0], Zq[..., 1], Zq[..., 2:2 + D]
    # i is its left partner's final merge iff the merged span [p, q) is
    # exactly p's own subtree span [p, next_ge[p])
    last_merge = Zp[..., 2 + D] == q.to(Zp.dtype)
    par = torch.where(last_merge, p_c, q_c)
    g = torch.where(last_merge, b_p, a_q)
    d = torch.where(last_merge[..., None], a_p[..., None] * T_p, (-b_q)[..., None] * T_q)
    root_child = last_merge & (p == 0)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    g = torch.where(root_child, zero, g)
    d = torch.where(root_child[..., None], dc, d)
    g = torch.where(root, zero, g)
    d = torch.where(root[..., None], dc, d)
    par = torch.where(root, torch.zeros_like(par), par)
    return par, g, d


def _chain_rounds(levels: int) -> int:
    """Doubling rounds: every chain ascends >= 1 level a hop and ends at
    node 0 (g == 0)."""
    return max(1, math.ceil(math.log2(levels + 1)))


def _chain_round(g, d, par, gp, dp, pp):
    """One doubling round from each row's parent's g, d and par."""
    return g * gp, d + g[..., None] * dp, pp


def _chain_halves(a, b, Y, T64):
    """(x0, x1): the left and right child values of every pair."""
    return a[..., None] * Y - b[..., None] * T64, b[..., None] * Y + a[..., None] * T64


def _chain_leaves(x0_next, x1, Y, nxt_is_child, root):
    """Leaf k: x0[k+1] when k+1 is k's right child, else x1[k]; a lone root
    (N == 1) is the DC itself."""
    out = torch.where(nxt_is_child[..., None], x0_next, x1)
    lone = root & ~nxt_is_child
    return torch.where(lone[..., None], Y, out)
