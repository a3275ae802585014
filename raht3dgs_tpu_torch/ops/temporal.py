"""Inter-frame attribute prediction over sorted Morton codes.

Counterpart of ``raht3dgs_tpu/ops/temporal.py``: frame t's attributes are
predicted from frame t-1's *reconstruction*, so the sequence codec
(``models/temporal.py``) codes only the residual. Each current voxel probes
a fixed set of neighbour offsets (itself and its 6 face neighbours, or the
whole 3x3x3 shell) around its motion-compensated position, Morton-encodes
each probe and looks it up among the previous frame's sorted codes; the
nearest occupied probe wins. Everything is integer work on the frame's
device, deterministic from (codes_t, codes_prev, recon_prev), which the
decoder also holds, so encoder and decoder predict the same bits.

Two joins answer the probe lookups with the same integers: ``"search"``
(``torch.searchsorted`` over the previous codes) and ``"sort"`` (one stable
sort of the previous codes and the probes together). ``join=None`` takes
:data:`DEFAULT_JOIN`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from raht3dgs_tpu_torch.ops.morton import morton_decode, morton_encode
from raht3dgs_tpu_torch.ops.raht_span import _two_sum
from raht3dgs_tpu_torch.ops.segment import sorted_segment_sums

# probe sets: offsets ordered by squared distance (ties in a fixed order)
_FACE7 = (
    (0, 0, 0),
    (-1, 0, 0), (1, 0, 0),
    (0, -1, 0), (0, 1, 0),
    (0, 0, -1), (0, 0, 1),
)
_SHELL27 = tuple(
    sorted(
        ((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)),
        key=lambda o: (o[0] * o[0] + o[1] * o[1] + o[2] * o[2], o),
    )
)
JOINS = ("search", "sort")
# the join taken when the caller names none: on the H100 the 27-probe
# lookups by searchsorted beat the sort join 1.3x (chip_smoke.py phase 13,
# PERF.md); both give the same integers, so encoder and decoder may differ
DEFAULT_JOIN = "search"


def _join(join: Optional[str]) -> str:
    join = join or DEFAULT_JOIN
    if join not in JOINS:
        raise ValueError(f"unknown join {join!r} (choose from {JOINS})")
    return join


def _probe_codes(P, offsets, lim: int, depth: int, code_dtype) -> torch.Tensor:
    """(N, K) probe codes: clamp(P + offset) Morton-encoded per offset."""
    offs = torch.as_tensor(offsets, device=P.device).to(P.dtype)     # (K, 3)
    Q = torch.clamp(P[:, None, :] + offs[None, :, :], 0, lim)       # (N, K, 3)
    K = offs.shape[0]
    return morton_encode(Q.reshape(-1, 3), depth).to(code_dtype).reshape(-1, K)


def _probe_match_search(codes_probe, codes_prev, occ_prev):
    """(hit (N, K) bool, idx (N, K) int64): each probe's left insertion
    point among ``codes_prev``, clamped to the last row, and whether that
    row holds the probe's code and is occupied. One ``searchsorted`` over
    all K columns (the same lookups as one per column)."""
    nprev = codes_prev.shape[0]
    idx = torch.clamp(torch.searchsorted(codes_prev, codes_probe.contiguous()), 0, nprev - 1)
    return (codes_prev[idx] == codes_probe) & occ_prev[idx], idx


def _probe_match_sort(codes_probe, codes_prev, occ_prev):
    """The same result as :func:`_probe_match_search` through a sort join.

    A stable sort of [prev codes ++ flattened probes] orders equal codes by
    their position, prev rows first: the JAX package's (code, tag) order.
    The previous codes are unique and sorted, so the r-th previous row in
    the merge is ``codes_prev[r]``, and ``cumsum(is_prev) - 1`` names each
    probe's candidate match. The sort's permutation (unique tags) scatters
    the results back to the (N, K) layout."""
    N, K = codes_probe.shape
    nprev = codes_prev.shape[0]
    key = torch.cat([codes_prev, codes_probe.reshape(-1)])
    k_s, t_s = torch.sort(key, stable=True)
    is_prev = t_s < nprev
    rank = torch.cumsum(is_prev.to(torch.int32), 0, dtype=torch.int32) - 1
    rank_c = torch.clamp(rank, 0, nprev - 1).to(torch.int64)
    hit_s = (codes_prev[rank_c] == k_s) & (rank >= 0) & occ_prev[rank_c] & ~is_prev
    hit = torch.empty_like(hit_s)
    idx = torch.empty_like(rank_c)
    hit[t_s] = hit_s
    idx[t_s] = rank_c
    return hit[nprev:].reshape(N, K), idx[nprev:].reshape(N, K)


def _probe_match(codes_probe, codes_prev, occ_prev, join: str):
    if join == "sort":
        return _probe_match_sort(codes_probe, codes_prev, occ_prev)
    return _probe_match_search(codes_probe, codes_prev, occ_prev)


def _first_true(hit: torch.Tensor) -> torch.Tensor:
    """Column of each row's first True (0 for a row without one): argmax
    keeps the first maximum; bool argmax is not supported everywhere."""
    return torch.argmax(hit.to(torch.int8), dim=1)


def estimate_global_motion(codes_t, weights_t, codes_prev, weights_prev, depth: int,
                           join: Optional[str] = None) -> torch.Tensor:
    """The dominant integer translation between two frames, derived from
    geometry alone: the occupied centroids' difference, then among the zero
    vector and the 8 floor/ceil roundings of it the one with the most
    occupied current voxels landing on occupied previous ones (the first
    in that fixed order on a tie). Only occupied voxels vote: pad sentinels
    decode to in-range positions. Returns a (3,) int32 shift such that
    frame t's content sits near ``previous + shift``."""
    dev = codes_t.device
    join = _join(join)
    lim = 2**depth - 1
    P_t = morton_decode(codes_t, depth)
    P_p = morton_decode(codes_prev, depth)
    occ_t = weights_t > 0
    occ_tf = occ_t.to(torch.float64)
    occ_pf = (weights_prev > 0).to(torch.float64)
    # integer-valued float64 sums: exact in any order
    c_t = (P_t * occ_tf[:, None]).sum(0) / torch.clamp(occ_tf.sum(), min=1.0)
    c_p = (P_p * occ_pf[:, None]).sum(0) / torch.clamp(occ_pf.sum(), min=1.0)
    lo = torch.floor(c_t - c_p).to(torch.int32)
    corners = torch.tensor([[bx, by, bz] for bx in (0, 1) for by in (0, 1) for bz in (0, 1)],
                           dtype=torch.int32, device=dev)
    cands = torch.cat([torch.zeros((1, 3), dtype=torch.int32, device=dev),
                       lo[None, :] + corners])                              # (9, 3)
    cp = _probe_codes(P_t, -cands.to(P_t.dtype), lim, depth, codes_prev.dtype)
    hit, _ = _probe_match(cp, codes_prev, weights_prev > 0, join)
    counts = (hit & occ_t[:, None]).sum(0)
    return cands[torch.argmax(counts)]


def _block_mean_shift(vals, first, seg, min_hits: int, method: str) -> torch.Tensor:
    """(N, 3) int32 rounded block means of the witness offsets ``vals``
    ((N, 4): offsets and a count lane), 0 where a block holds fewer than
    ``min_hits`` witnesses."""
    sums, _, _, _ = sorted_segment_sums(vals, first, method=method)
    cnt = sums[seg, 3]
    mean = sums[seg, :3] / torch.clamp(cnt, min=1.0)[:, None]
    return torch.where((cnt >= min_hits)[:, None], torch.round(mean),
                       torch.zeros_like(mean)).to(torch.int32)


def _motion_rows(motion, P: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(motion, device=P.device).to(P.dtype).expand(P.shape)


def refine_block_motion(codes_t, weights_t, codes_prev, weights_prev, depth: int, motion,
                        block_side_log: int = 4, probes: int = 27, min_hits: int = 8,
                        join: Optional[str] = None) -> torch.Tensor:
    """Per-voxel integer motion refined over octree blocks from geometry
    alone (the v2 stream's derived motion): probe around ``position -
    motion``, average each ``2^block_side_log``-side block's winning
    (nearest hit) probe offsets, round, and subtract; blocks with fewer than
    ``min_hits`` matches keep ``motion``. Returns (N, 3) int32."""
    dev = codes_t.device
    join = _join(join)
    offsets = {7: _FACE7, 27: _SHELL27}[probes]
    P0 = morton_decode(codes_t, depth)
    P = P0 - _motion_rows(motion, P0)
    cp = _probe_codes(P, offsets, 2**depth - 1, depth, codes_prev.dtype)
    hit, _ = _probe_match(cp, codes_prev, weights_prev > 0, join)
    found = hit.any(1)
    # offsets are distance-ordered: the first hit is the nearest probe
    woff = torch.tensor(offsets, dtype=torch.float64, device=dev)[_first_true(hit)] \
        * found[:, None]
    valid = found & (weights_t > 0)
    first = block_first(codes_t, depth, block_side_log)
    vals = torch.cat([woff * valid[:, None], valid[:, None].to(torch.float64)], dim=1)
    seg = (torch.cumsum(first.to(torch.int32), 0) - 1).to(torch.int64)
    # the v2 decoder replays this arithmetic: the prefix method is pinned
    # (integer-valued lanes, exact under any association all the same)
    extra = _block_mean_shift(vals, first, seg, min_hits, "prefix")
    return torch.as_tensor(motion, device=dev).to(torch.int32).expand(extra.shape) - extra


def _two_prod(a, b):
    """(p, e) with p + e == a * b exactly (Veltkamp split, no overflow)."""
    p = a * b
    t = a * 134217729.0
    ah = t - (t - a)
    al = a - ah
    t = b * 134217729.0
    bh = t - (t - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma(a, b, c):
    """a * b + c rounded once, in float64 on any device: Boldo and
    Melquiond's emulation (the exact product and sum, their tail added
    with rounding to odd, then one rounding to nearest)."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, e = _two_sum(tl, ul)
    bits = v.contiguous().view(torch.int64)
    # rounding to odd: an inexact sum whose last bit is even moves one ulp
    # toward the exact value (v is never 0 while e is not)
    step = torch.where((e > 0) == (v > 0), 1, -1)
    bits = torch.where((e != 0) & ((bits & 1) == 0), bits + step, bits)
    return th + bits.view(torch.float64)


def _witness_offsets(P_rows, at_rows, occ_rows, mv_rows, codes_prev, attrs_prev, occ_p,
                     lim: int, depth: int, join: str):
    """Each row's displacement witness: among the hit 27-shell probes of
    the compensated position, the one whose previous-frame attributes are
    nearest the row's (the first on a tie). The squared error over the
    channels is formed in float64 as the JAX package's XLA:CPU program forms
    it, a chain of fused multiply-adds in channel order: blocks that
    reconstruct to one value tie exactly, and the last bits of the error
    break those ties. Returns (woff (N, 3) float64, zero on invalid rows;
    valid (N,) bool)."""
    dev = P_rows.device
    cp = _probe_codes(P_rows - mv_rows, _SHELL27, lim, depth, codes_prev.dtype)
    hit, idx = _probe_match(cp, codes_prev, occ_p, join)
    d = attrs_prev[idx].to(torch.float64) - at_rows[:, None, :]           # (N, 27, D)
    err = d[..., 0] * d[..., 0]
    for c in range(1, d.shape[2]):
        err = _fma(d[..., c], d[..., c], err)
    err = torch.where(hit, err, torch.full_like(err, float("inf")))
    win = torch.argmin(err, dim=1)                                        # first min
    valid = hit.any(1) & occ_rows
    woff = torch.tensor(_SHELL27, dtype=torch.float64, device=dev)[win] * valid[:, None]
    return woff, valid


def search_block_motion(codes_t, attrs_t, weights_t, codes_prev, attrs_prev, weights_prev,
                        depth: int, motion, block_side_log: int = 4, iters: int = 2,
                        min_hits: int = 8, join: Optional[str] = None,
                        stride: int = 1) -> torch.Tensor:
    """Encoder-side per-block motion searched against the true residual.

    Frame t's attributes pick each voxel's witness (:func:`_witness_offsets`),
    each octree block takes the rounded mean of its witnesses, and the
    search iterates ``iters`` times, reaching +-``iters`` voxels around
    ``motion``. The result is block-constant (pads share their block's
    vector and never vote), so row 0 of each occupied block is the field
    the v3 stream signals. ``stride`` > 1 takes witnesses from every
    stride-th row only (sampled counts scale back against ``min_hits``).
    Returns (N, 3) int32: content sits near ``position - motion``."""
    dev = codes_t.device
    join = _join(join)
    P0 = morton_decode(codes_t, depth)
    lim = 2**depth - 1
    occ_t = weights_t > 0
    occ_p = weights_prev > 0
    at = attrs_t.to(torch.float64)
    first = block_first(codes_t, depth, block_side_log)
    seg = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    if stride > 1:
        return _search_strided(P0, at, occ_t, seg, codes_prev, attrs_prev, occ_p, depth,
                               motion, lim, iters, min_hits, join, stride)
    seg_i = seg.to(torch.int64)
    mv = torch.as_tensor(motion, device=dev).to(torch.int32).expand(P0.shape)
    for _ in range(iters):
        woff, valid = _witness_offsets(P0, at, occ_t, mv.to(P0.dtype), codes_prev,
                                       attrs_prev, occ_p, lim, depth, join)
        vals = torch.cat([woff, valid[:, None].to(torch.float64)], dim=1)
        # the witness offset points from the compensated position toward the
        # previous content (content at P - mv + off), so mv' = mv - off
        mv = mv - _block_mean_shift(vals, first, seg_i, min_hits, "shift")
    return mv


def _search_strided(P0, at, occ_t, seg, codes_prev, attrs_prev, occ_p, depth, motion, lim,
                    iters, min_hits, join, stride):
    """:func:`search_block_motion` with witnesses from every ``stride``-th
    row: block means of the sampled witnesses map back to every row through
    one ``searchsorted`` over the sampled blocks' ids (int32 max past the
    last block)."""
    dev = P0.device
    P0s, ats, occ_ts, segs = P0[::stride], at[::stride], occ_t[::stride], seg[::stride]
    Ns = P0s.shape[0]
    first_s = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), segs[1:] != segs[:-1]])
    sentinel = torch.iinfo(torch.int32).max
    slot = torch.arange(Ns, device=dev)
    mv = torch.as_tensor(motion, device=dev).to(torch.int32).expand(P0.shape)
    for _ in range(iters):
        woff, valid = _witness_offsets(P0s, ats, occ_ts, mv[::stride].to(P0.dtype),
                                       codes_prev, attrs_prev, occ_p, lim, depth, join)
        vals = torch.cat([woff, valid[:, None].to(torch.float64)], dim=1)
        # the float64 accumulator carries the int32 block id exactly
        sums_s, blk_extra, _, n_seg_s = sorted_segment_sums(
            vals, first_s, extra_rows=segs[:, None].to(torch.float64))
        blk = torch.where(slot < n_seg_s, blk_extra[:, 0].to(torch.int32),
                          torch.full((Ns,), sentinel, dtype=torch.int32, device=dev))
        r = torch.clamp(torch.searchsorted(blk, seg), max=Ns - 1)
        present = blk[r] == seg
        cnt = torch.where(present, sums_s[r, 3], torch.zeros((), dtype=torch.float64,
                                                                 device=dev))
        mean = sums_s[r, :3] / torch.clamp(cnt, min=1.0)[:, None]
        extra = torch.where(((cnt * stride >= min_hits) & present)[:, None],
                            torch.round(mean), torch.zeros_like(mean)).to(torch.int32)
        mv = mv - extra
    return mv


def block_first(codes, depth: int, block_side_log: int = 4):
    """(N,) bool marking the first row of each octree block (a run of equal
    top code bits) of the sorted ``codes``, a numpy array or a tensor. The
    encoder and the decoder map signalled per-block motion to voxels by
    this rule, so the mapping does not depend on the padded size."""
    if isinstance(codes, torch.Tensor):
        bid = codes >> (3 * (depth - block_side_log)) if depth > block_side_log \
            else torch.zeros_like(codes)
        return torch.cat([torch.ones(1, dtype=torch.bool, device=codes.device),
                          bid[1:] != bid[:-1]])
    if depth > block_side_log:
        # the shift in the code dtype: uint64 >> int promotes to float64 in numpy
        bid = codes >> codes.dtype.type(3 * (depth - block_side_log))
    else:
        bid = np.zeros_like(codes)
    return np.concatenate([np.ones((1,), bool), bid[1:] != bid[:-1]])


def predict_from_previous(codes_t, codes_prev, attrs_prev, weights_prev, depth: int,
                          probes: int = 7, motion=None, join: Optional[str] = None):
    """Each voxel's attributes predicted from the previous frame.

    ``codes_t`` / ``codes_prev`` are padded sorted Morton codes (pads last),
    ``attrs_prev`` the previous frame's reconstruction (zeros in pads),
    ``weights_prev`` its weights (0 marks padding), ``probes`` 7 or 27,
    ``motion`` a (3,) or (N, 3) integer shift to probe around ``position -
    motion``. Returns (pred (N, D): the nearest occupied probe's attributes,
    zeros where none hit; found (N,) bool). Pad rows of the current frame
    carry arbitrary values: mask them with its weights."""
    dev = codes_t.device
    join = _join(join)
    offsets = {7: _FACE7, 27: _SHELL27}[probes]
    P = morton_decode(codes_t, depth)
    if motion is not None:
        P = P - torch.as_tensor(motion, device=dev).to(P.dtype)
    cp = _probe_codes(P, offsets, 2**depth - 1, depth, codes_prev.dtype)
    hit, idx = _probe_match(cp, codes_prev, weights_prev > 0, join)
    found = hit.any(1)
    # distance-ordered offsets: the first hit is the nearest
    win_idx = torch.gather(idx, 1, _first_true(hit)[:, None])[:, 0]
    pred = attrs_prev[win_idx] * found[:, None].to(attrs_prev.dtype)
    return pred, found
