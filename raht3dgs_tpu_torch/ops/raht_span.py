"""Closed-form ("span") RAHT: no per-level loop.

Counterpart of ``raht3dgs_tpu/ops/raht_span.py`` (the math is laid out in
its docstring and in docs/span_math.md). For sorted unique codes the merge
tree is closed-form: ``B[i] = msb(code[i-1] ^ code[i])``, node ``i`` drops
at ``B[i] + 1``, its partner is ``prev_ge[i]`` and its span ends at
``next_ge[i]``; every butterfly input is a difference of prefix sums.

Float32 prefix sums run in compensated double-single arithmetic through
the CUDA kernel of ``ops/ds_scan.py`` (its plain version on the CPU);
float64 keeps plain float64 sums. Every float64 expression here is written
as single IEEE operations (no fused multiply-add, no ``addcmul``), so the
port's CPU and CUDA runs give the same float64 bits wherever the prefix
sums are exact.

The ``*_batched`` forms at the end run a (B, N, ...) stack of equally
padded frames, as the JAX package's batched codec ``jax.vmap``s these
functions (``parallel/sharding.py``): the same operations in the same
order for every frame, with the f32 prefix packs through the scan kernel's
batched entry (one launch per stack), so frame b's result equals the
single-frame function's on frame b bit for bit. The single-frame functions
never call them.

Not ported yet: the tiered nearest->= variant and the ``fill`` inverse
(opt-in alternatives in the JAX package with equal results; ROADMAP).
"""

from __future__ import annotations

import math

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


def _msb(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Position of the most significant set bit (x > 0), exact, int32.

    The float32 exponent is the first guess, corrected where rounding
    carried up to the next power of two. Inputs wider than 31 bits are
    split into 32-bit halves in int64 (codes stay below 2^63)."""

    def msb32(v):  # int32/int64 tensor, 0 <= v < 2^32
        vf = v.to(torch.float32)
        e = ((vf.view(torch.int32) >> 23) & 0xFF) - 127
        e = torch.clamp(e, 0, 31).to(torch.int32)
        carry = (v >> e.to(v.dtype)) == 0  # rounded up: true msb is e - 1
        return torch.where(carry, e - 1, e)

    if bits <= 31:
        return msb32(x & 0x7FFFFFFF)
    x = x.to(torch.int64)
    hi = x >> 32
    lo = x & 0xFFFFFFFF
    return torch.where(hi > 0, 32 + msb32(hi), msb32(lo)).to(torch.int32)


def _nearest_ge_flat(B: torch.Tensor, n_vals: int, W: torch.Tensor = None):
    """prev_ge[i] (previous j with B[j] >= B[i], else -1) and next_ge[i]
    (next k with B[k] >= B[i], else N), batched over the value alphabet
    with one (V, N) cummax / reverse cummin; each element then reads its
    own threshold row.

    With ``W`` (an ``(N+1,)`` nondecreasing prefix array) also returns
    ``W[max(prev_ge, 0)]`` and ``W[next_ge]``, propagated as values through
    the same scans (bitwise equal to the gathers, by monotonicity)."""
    N = B.shape[0]
    dev = B.device
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    vals = torch.arange(n_vals, dtype=B.dtype, device=dev)
    ge = B[None, :] >= vals[:, None]                       # (V, N)
    neg1 = torch.full((), -1, dtype=torch.int32, device=dev)
    nfill = torch.full((), N, dtype=torch.int32, device=dev)
    last = torch.cummax(torch.where(ge, idx, neg1), dim=1).values
    nxt = torch.cummin(torch.where(ge, idx, nfill).flip(1), dim=1).values.flip(1)
    # strictly-before / strictly-after: shift the inclusive scans by one
    # and read each element's own row B[i]
    rows = B.to(torch.int64)[None, :]
    last_excl = torch.cat([torch.full((n_vals, 1), -1, dtype=torch.int32, device=dev),
                           last[:, :-1]], dim=1)
    next_excl = torch.cat([nxt[:, 1:],
                           torch.full((n_vals, 1), N, dtype=torch.int32, device=dev)],
                          dim=1)
    prev_ge = torch.gather(last_excl, 0, rows)[0]
    next_ge = torch.gather(next_excl, 0, rows)[0]
    if W is None:
        return prev_ge, next_ge
    Wrow = W[:N]
    w_total = W[N]
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
        prev_ge, next_ge = _nearest_ge_flat(B, levels + 2)
        return drop, prev_ge, next_ge, levels, B
    prev_ge, next_ge, w_prev, w_next = _nearest_ge_flat(B, levels + 2, W)
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
    float32 runs the ds scan (exact for integer weights), float64 a plain
    float64 cumsum."""
    if fdtype == torch.float32:
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
    if fdtype == torch.float32:
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

    use_ds = fdtype == torch.float32
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
            "float64 I/O"
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


def raht_inverse_span(coeffs: torch.Tensor, codes: torch.Tensor,
                      weights: torch.Tensor, depth: int) -> torch.Tensor:
    """Closed-form inverse RAHT (decoder side of :func:`raht_forward_span`):
    the pointer-doubling chain. The JAX package's opt-in ``fill`` inverse is
    not ported yet."""
    return _raht_inverse_span_chain(coeffs, codes, weights, depth)


# -- batched forms: a (B, N, ...) stack of frames of one padded size ----------


def _rows_batched(P: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``P[b, idx[b, i]]`` for a (B, M, C) stack and (B, N) indices, as
    (B, N, C): one row gather over the flattened stack, each frame's
    indices offset by b * M."""
    B, M, C = P.shape
    off = torch.arange(B, dtype=torch.int64, device=idx.device)[:, None] * M
    return P.reshape(B * M, C)[(idx.long() + off).reshape(-1)].reshape(B, -1, C)


def _nearest_ge_batched(B: torch.Tensor, n_vals: int, W: torch.Tensor = None):
    """:func:`_nearest_ge_flat` of every row of ``B (F, N)``, one (F, V, N)
    cummax / reverse cummin; ``W`` (F, N+1) as there."""
    F, N = B.shape
    dev = B.device
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    vals = torch.arange(n_vals, dtype=B.dtype, device=dev)
    ge = B[:, None, :] >= vals[None, :, None]              # (F, V, N)
    neg1 = torch.full((), -1, dtype=torch.int32, device=dev)
    nfill = torch.full((), N, dtype=torch.int32, device=dev)
    last = torch.cummax(torch.where(ge, idx, neg1), dim=2).values
    nxt = torch.cummin(torch.where(ge, idx, nfill).flip(2), dim=2).values.flip(2)
    rows = B.to(torch.int64)[:, None, :]
    last_excl = torch.cat([torch.full((F, n_vals, 1), -1, dtype=torch.int32, device=dev),
                           last[:, :, :-1]], dim=2)
    next_excl = torch.cat([nxt[:, :, 1:],
                           torch.full((F, n_vals, 1), N, dtype=torch.int32, device=dev)],
                          dim=2)
    prev_ge = torch.gather(last_excl, 1, rows)[:, 0]
    next_ge = torch.gather(next_excl, 1, rows)[:, 0]
    if W is None:
        return prev_ge, next_ge
    Wrow = W[:, None, :N]
    w_total = W[:, N, None, None]
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
    if fdtype == torch.float32:
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


def _pair_weights_batched(codes: torch.Tensor, weights: torch.Tensor, depth: int,
                          fdtype):
    """:func:`_pair_weights` of every frame of a (F, N) stack."""
    N = codes.shape[1]
    if fdtype == torch.float32:
        drop, prev_ge, next_ge, levels, B = _span_topology_batched(codes, depth)
        P = _prefix_pack_batched(weights.to(torch.float32)[..., None], True)
        here = P[:, :N]
        g_next = _rows_batched(P, next_ge)
        g_prev = _rows_batched(P, torch.clamp(prev_ge, min=0))
        w1 = _prefix_diff(g_next[..., :1], g_next[..., 1:], here[..., :1], here[..., 1:])[..., 0]
        w0 = _prefix_diff(here[..., :1], here[..., 1:], g_prev[..., :1], g_prev[..., 1:])[..., 0]
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
    node_w = torch.where(is0, w_total[:, None], w0 + w1).to(fdtype)
    subtree = torch.where(is0, w_total[:, None], w1).to(fdtype)
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

    use_ds = fdtype == torch.float32
    acc_dt = torch.float32 if use_ds else torch.float64
    w_acc = weights.to(acc_dt)
    sw = ieee_sqrt(w_acc)[..., None]
    body = torch.cat([sw * attributes.to(acc_dt), w_acc[..., None]], dim=2)
    K = D + 1
    SW = _prefix_pack_batched(body, use_ds)

    SW_here = SW[:, :N]
    g_next = _rows_batched(SW, next_ge)
    g_prev = _rows_batched(SW, torch.clamp(prev_ge, min=0))
    if use_ds:
        sub = _prefix_diff(g_next[..., :K], g_next[..., K:], SW_here[..., :K], SW_here[..., K:])
        sub1, w1 = sub[..., :D], sub[..., D]
        sub = _prefix_diff(SW_here[..., :K], SW_here[..., K:], g_prev[..., :K], g_prev[..., K:])
        sub0, w0 = sub[..., :D], sub[..., D]
        totals = SW[:, N, :K] + SW[:, N, K:]
        w_total = totals[:, D]
        total_S = totals[:, :D]
    else:
        sub1 = g_next[..., :D] - SW_here[..., :D]
        sub0 = SW_here[..., :D] - g_prev[..., :D]
        w1 = g_next[..., D] - SW_here[..., D]
        w0 = SW_here[..., D] - g_prev[..., D]
        w_total = SW[:, N, D]
        total_S = SW[:, N, :D]
    x1 = _guarded_scale(sub1, w1)
    x0 = _guarded_scale(sub0, w0)
    a, b = _butterfly_ab(w0, w1)
    detail = ((-b[..., None]) * x0 + a[..., None] * x1).to(fdtype)

    w_root = ieee_sqrt(torch.where(w_total > 0, w_total, torch.ones_like(w_total)))
    dc = (total_S / w_root[:, None]).to(fdtype)
    T = torch.where((idx == 0)[None, :, None], dc[:, None, :], detail)

    node_w = torch.where(idx == 0, w_total[:, None], w0 + w1).to(fdtype)
    subtree = torch.where(idx == 0, w_total[:, None], w1).to(fdtype)
    return RahtForwardResult(
        coeffs=T,
        weights=node_w,
        structure=RahtStructure(drop_level=drop, subtree_w=subtree,
                                node_weights=node_w),
    )


def raht_inverse_span_batched(coeffs: torch.Tensor, codes: torch.Tensor,
                              weights: torch.Tensor, depth: int) -> torch.Tensor:
    """:func:`raht_inverse_span` (the pointer-doubling chain) of every frame
    of ``coeffs (F, N, D)``; returns (F, N, D)."""
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
    nf = next_ge.to(T64.dtype)
    Z = torch.cat([a[..., None].to(T64.dtype), b[..., None].to(T64.dtype), T64,
                   nf[..., None]], dim=2)
    Zp = _rows_batched(Z, p_c)
    Zq = _rows_batched(Z, q_c)
    a_p, b_p, T_p = Zp[..., 0], Zp[..., 1], Zp[..., 2:2 + D]
    a_q, b_q, T_q = Zq[..., 0], Zq[..., 1], Zq[..., 2:2 + D]
    last_merge = Zp[..., 2 + D] == q.to(T64.dtype)

    par = torch.where(last_merge, p_c, q_c)
    g = torch.where(last_merge, b_p, a_q)
    d = torch.where(last_merge[..., None], a_p[..., None] * T_p, (-b_q)[..., None] * T_q)
    root_child = last_merge & (p == 0)
    zero = torch.zeros((), dtype=g.dtype, device=dev)
    dc = T64[:, :1, :]
    g = torch.where(root_child, zero, g)
    d = torch.where(root_child[..., None], dc, d)
    is0 = idx == 0
    g = torch.where(is0, zero, g)
    d = torch.where(is0[None, :, None], dc, d)
    par = torch.where(is0, torch.zeros_like(par), par)

    steps = max(1, math.ceil(math.log2(levels + 1)))
    for _ in range(steps):
        gp = torch.gather(g, 1, par)
        dp = _rows_batched(d, par)
        d = d + g[..., None] * dp
        g = g * gp
        par = torch.gather(par, 1, par)
    Y = d

    x0 = a[..., None] * Y - b[..., None] * T64
    x1 = b[..., None] * Y + a[..., None] * T64

    nxt_is_child = torch.cat([prev_ge[:, 1:] == idx[:-1].to(prev_ge.dtype),
                              torch.zeros((F, 1), dtype=torch.bool, device=dev)], dim=1)
    x0_next = torch.cat([x0[:, 1:], x0[:, -1:]], dim=1)
    out = torch.where(nxt_is_child[..., None], x0_next, x1)
    lone = is0 & ~nxt_is_child
    out = torch.where(lone[..., None], Y, out)
    return out.to(fdtype)
