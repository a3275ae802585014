"""The point-sharded span codec: a mesh group's frames, their points split
over the sp axis, transformed, ordered and inverted shard by shard.

Counterpart of what XLA's sharded scans do for the JAX package's ``sp``
axis (``raht3dgs_tpu/parallel/sharding.py``: "the N axis itself shards").
One (dp, tp) group's sp shards hold rows [a_j, a_j + n_j) of every frame
(``codes``, ``attrs``, ``weights`` as (F, n_j, ...) tensors on the shards'
devices, in point order; a mesh may name one device many times). Each
function here runs phase by phase, every shard on its own rows with its
device current, and between the phases only these cross (``SpGroup.send``,
counted in the caller's ``counts["sp_exchange_bytes"]``, on a virtual mesh
too):

- the last code of the shard before (one int a frame) for its first B;
- each shard's (F, V) vectors of the last and the first global row with B
  >= v, chained over the shards by max from the left and min from the
  right (exact integers): they replace the -1 / N sentinels of the
  nearest->= scans, so prev_ge / next_ge are the unsharded ones;
- the prefix packs' halos, tile totals, returned rows and leading rows
  (``ops/ds_scan.py:ds_prefix_pack_sharded``), or for float64 sums the
  previous shard's last inclusive row (a carry-first ``torch.cumsum``);
- boundary tables: (F, V, C) rows of a pack (or of the chain's lanes, or
  of the fill's terms) at those carry rows, chained the same way, so a row
  whose prev_ge or next_ge lies in another shard reads the entry of its own
  B; and the pack's last row (the totals) for the DC row;
- the chain inverse's crossing nodes (spans containing a shard edge: at
  most (S - 1) * (levels + 2), a set closed under ancestry) before every
  doubling round, each shard's snapshot of their (g, d, par) sent to every
  other shard, and the one-row halos of x0 and prev_ge, and T[0];
- the orders' per-shard key histograms (and for ``weight_desc`` the node
  weight column, gathered on the group's first shard for one stable
  argsort, and the positions sent back); the roundtrip's 2048-row
  squared-error halos and block sums.

Every float32 result is bitwise the batched unsharded function's
(``ops/raht_span.py``), on the CPU and on the card: every element's
operands and operations are the same. Integer weights sum exactly in any
association. Float64 prefix sums (float64 frames, ``RAHT3DGS_SPAN_SUMS=f64``)
add the previous shard's last row to a shard's first: bitwise the
unsharded ``torch.cumsum`` on the CPU, which adds in row order, within
1e-12 relative on the card, whose scan associates by N.

Bytes that cross, for F frames of one group over S shards (c the
coefficients' element size, V = levels + 2, K pack columns):

- topology: (S - 1)F codes and 8(S - 1)FV of int32 carries, and with the
  weight prefix 2c(S - 1)FV more for the carries' W values;
- a pack: the float32 scan's halos, totals and leading rows
  (``ds_prefix_pack_sharded``'s count) or 8(S - 1)FK of float64 carries;
  its last row, cFC to the first shard (C = 2K float32 or K float64); its
  two boundary tables, 2c(S - 1)FVC;
- :func:`forward`: topology, the (D + 1)-column pack, its last row and
  tables;
- the chain inverse: the weight prefix and its total to every shard,
  topology, the (D + 3)-lane tables, T[0] to every shard, each shard's
  2V crossing-node ids (8 bytes) to every other shard once, then a
  doubling round S(S - 1) * F * 2V * (c(D + 1) + 8), and the leaves'
  halos;
- the rest as each function says.
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Optional, Sequence

import torch

from raht3dgs_tpu_torch.ops import raht_span as rs
from raht3dgs_tpu_torch.ops.ds_scan import TILE, ds_prefix_pack_sharded, halo, shard_plan
from raht3dgs_tpu_torch.ops.raht import _butterfly_ab, ieee_sqrt, num_levels


class SpGroup:
    """The sp shards of one mesh group: their devices in point order, their
    row counts, and the tally of the bytes that cross between them."""

    def __init__(self, devices: Sequence[torch.device], sizes: Sequence[int], counts: dict):
        self.devices = [torch.device(d) for d in devices]
        self.sizes = [int(n) for n in sizes]
        self.starts = [sum(self.sizes[:j]) for j in range(len(self.sizes))]
        self.n = sum(self.sizes)
        self.S = len(self.sizes)
        self.counts = counts

    def send(self, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        """``t`` moved to ``dev``, its bytes counted as crossing."""
        return self.count(t, dev).to(dev)

    def count(self, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        """``t``'s bytes counted as crossing to ``dev``, for a piece that
        its receiver moves itself (the sharded scan's)."""
        self.counts["sp_exchange_bytes"] = (self.counts.get("sp_exchange_bytes", 0)
                                            + t.numel() * t.element_size())
        return t

    def on(self, j: int):
        """Shard j's device made current."""
        dev = self.devices[j]
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    def each(self, fn, *per_shard):
        """``[fn(j, *args_j) for every shard j]``, each with its device current."""
        out = []
        for j in range(self.S):
            with self.on(j):
                out.append(fn(j, *(a[j] for a in per_shard)))
        return out

    def rows(self, j: int, dev: torch.device) -> torch.Tensor:
        """Shard j's global row indices, int64."""
        a = self.starts[j]
        return torch.arange(a, a + self.sizes[j], device=dev)

    def root(self, j: int, dev: torch.device) -> Optional[torch.Tensor]:
        """Shard j's row-0 mask, or None for a shard without global row 0."""
        return self.rows(j, dev) == 0 if j == 0 else None


# -- topology --------------------------------------------------------------------


class Topology(NamedTuple):
    """One shard's span topology, (F, n) with global row indices. ``left``
    / ``right``: (F, V) the nearest global row with B >= v before the shard
    (-1: none) and after it (N: none); ``own_last`` / ``own_first``: the
    shard's own last and first such row (-1 / N). With a weight prefix also
    ``w_prev`` / ``w_next`` and the carries' ``W`` values."""
    B: torch.Tensor
    drop: torch.Tensor
    prev_ge: torch.Tensor
    next_ge: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    own_last: torch.Tensor
    own_first: torch.Tensor
    levels: int
    w_prev: Optional[torch.Tensor] = None
    w_next: Optional[torch.Tensor] = None


def _extremes(B: torch.Tensor, rows: torch.Tensor, n_vals: int, n_all: int):
    """(F, V) last and first global row with B >= v among the shard's rows
    (-1 / ``n_all`` where none): a scatter max / min by B value, then a
    running max / min down the values."""
    F = B.shape[0]
    idx = rows.to(torch.int32).expand(F, -1)
    hi = torch.full((F, n_vals), -1, dtype=torch.int32, device=B.device)
    hi = hi.scatter_reduce(1, B.long(), idx, "amax")
    lo = torch.full((F, n_vals), n_all, dtype=torch.int32, device=B.device)
    lo = lo.scatter_reduce(1, B.long(), idx, "amin")
    return (torch.cummax(hi.flip(1), dim=1).values.flip(1),
            torch.cummin(lo.flip(1), dim=1).values.flip(1))


def _chain(grp: SpGroup, own: list, first, combine, from_left: bool) -> list:
    """The carry each shard receives: from the left, ``combine`` of the
    shards before it (``first`` on shard 0); from the right, of the shards
    after it (``first`` on the last shard)."""
    S = grp.S
    out = [None] * S
    order = range(S) if from_left else range(S - 1, -1, -1)
    prev = None
    for j in order:
        if prev is None:
            out[j] = first(j)
        else:
            with grp.on(prev):
                carry = combine(out[prev], own[prev])
            out[j] = grp.send(carry, grp.devices[j])
        prev = j
    return out


def topology(grp: SpGroup, codes: list, depth: int, W: list = None, w_total: list = None):
    """:func:`raht_span._span_topology_batched` of every shard, with
    ``levels`` from the global N and global row indices. ``W``: each
    shard's (F, n_j + 1) rows W[a_j ..] of the exclusive weight prefix and
    ``w_total`` the (F,) totals on every shard, for the W-propagated
    variant."""
    N, S = grp.n, grp.S
    levels = num_levels(depth, N)
    n_vals = levels + 2

    def first_b(j, c):
        if j == 0:
            F = c.shape[0]
            return torch.cat([torch.full((F, 1), levels + 1, dtype=torch.int32, device=c.device),
                              rs._msb(c[:, 1:] ^ c[:, :-1], levels).to(torch.int32)], dim=1)
        ext = torch.cat([grp.send(codes[j - 1][:, -1:], c.device), c], dim=1)
        return rs._msb(ext[:, 1:] ^ ext[:, :-1], levels).to(torch.int32)

    Bs = grp.each(first_b, codes)
    ext = grp.each(lambda j, B: _extremes(B, grp.rows(j, B.device), n_vals, N), Bs)
    own_last = [e[0] for e in ext]
    own_first = [e[1] for e in ext]
    left = _chain(grp, own_last, lambda j: torch.full_like(own_last[j], -1),
                  torch.maximum, True)
    right = _chain(grp, own_first, lambda j: torch.full_like(own_first[j], N),
                   torch.minimum, False)
    if W is not None:
        def w_at(j, at, fill):          # W at the shard's own rows `at` (F, V)
            a = grp.starts[j]
            got = torch.gather(W[j], 1, (at.long() - a).clamp(0, grp.sizes[j]))
            ok = (at >= a) & (at < a + grp.sizes[j])
            return torch.where(ok, got, fill)

        own_lw = grp.each(lambda j, at: w_at(j, at, torch.zeros((), dtype=W[j].dtype,
                                                                 device=at.device)), own_last)
        own_fw = grp.each(lambda j, at: w_at(j, at, w_total[j][:, None]), own_first)
        left_w = _chain(grp, own_lw, lambda j: torch.zeros_like(own_lw[j]), torch.maximum, True)
        right_w = _chain(grp, own_fw, lambda j: w_total[j][:, None].expand_as(own_fw[j]),
                         torch.minimum, False)

    def finish(j, B):
        a = grp.starts[j]
        F = B.shape[0]
        drop = (B + 1).to(torch.int32)
        if j == 0:
            drop = torch.cat([torch.zeros((F, 1), dtype=torch.int32, device=B.device),
                              drop[:, 1:]], dim=1)
        rows = B.long()
        if W is None:
            got = _nearest(B, n_vals, a, N)
        else:
            got = _nearest(B, n_vals, a, N, W[j], w_total[j])
        prev_ge = torch.maximum(got[0], torch.gather(left[j], 1, rows))
        next_ge = torch.minimum(got[1], torch.gather(right[j], 1, rows))
        extra = ()
        if W is not None:
            extra = (torch.maximum(got[2], torch.gather(left_w[j], 1, rows)),
                     torch.minimum(got[3], torch.gather(right_w[j], 1, rows)))
        return Topology(B, drop, prev_ge, next_ge, left[j], right[j], own_last[j],
                        own_first[j], levels, *extra)

    return grp.each(finish, Bs)


def _nearest(B, n_vals: int, idx0: int, n_all: int, W=None, w_total=None):
    """The shard's own nearest->= rows (global; -1 / ``n_all`` / 0 /
    ``w_total`` where it holds none): the batched flat scans, or with
    ``RAHT3DGS_NEARESTGE=tiered`` the tiered scans frame by frame."""
    if rs._NGE_MODE != "tiered":
        return rs._nearest_ge_batched(B, n_vals, W, idx0, n_all, w_total)
    per = [rs._nearest_ge_tiered(B[f], n_vals, None if W is None else W[f], idx0, n_all,
                                 None if W is None else w_total[f])
           for f in range(B.shape[0])]
    return tuple(torch.stack(t) for t in zip(*per))


# -- prefix sums and boundary reads ----------------------------------------------


def _cumsum_carry(grp: SpGroup, xs: list) -> list:
    """Float64 inclusive cumsums of the shards' (F, n_j, ...) rows as one
    array: the previous shard's last inclusive row added to a shard's first
    row, then each frame's ``torch.cumsum`` (the unsharded function's
    per-frame cumsum), with that carry as the leading row (zeros on shard
    0): (F, n_j + 1, ...)."""
    out = []
    carry = None
    for j, x in enumerate(xs):
        with grp.on(j):
            if carry is None:
                lead = torch.zeros_like(x[:, :1])
            else:
                lead = grp.send(carry, x.device)
                x = torch.cat([x[:, :1] + lead, x[:, 1:]], dim=1)
            P = torch.stack([torch.cumsum(r, dim=0) for r in x])
            out.append(torch.cat([lead, P], dim=1))
            carry = P[:, -1:]
    return out


def packs(grp: SpGroup, bodies: list, use_ds: bool) -> list:
    """:func:`raht_span._prefix_pack_batched` of the shards' (F, n_j, K)
    bodies as one array: each shard's (F, n_j + 1, C) rows P[a_j .. a_j +
    n_j] (float32 [hi | lo] through the sharded scan, or float64)."""
    if use_ds:
        return ds_prefix_pack_sharded([b.to(torch.float32).contiguous() for b in bodies],
                                      send=grp.count)
    return _cumsum_carry(grp, [b.to(torch.float64) for b in bodies])


def weight_prefix(grp: SpGroup, weights: list, fdtype):
    """:func:`raht_span._weight_prefix_batched` of the shards: each shard's
    (F, n_j + 1) rows W[a_j .. a_j + n_j], and the (F,) totals on every
    shard."""
    if rs._use_ds(fdtype):
        P = packs(grp, [w[..., None] for w in weights], True)
        W = [p[..., 0] + p[..., 1] for p in P]
    else:
        W = _cumsum_carry(grp, [w.to(torch.float64) for w in weights])
    last = W[-1][:, -1]
    return W, [last if j == grp.S - 1 else grp.send(last, grp.devices[j])
               for j in range(grp.S)]


def boundary_tables(grp: SpGroup, topo: list, X: list) -> list:
    """Each shard's (F, n_j + 2V, C) rows: its own (F, m_j, C) rows ``X``
    (row i at global row a_j + i), then the rows at ``right[v]`` (the last
    shard's last row where that is N, or past the end), then at
    ``left[v]``, fetched from the shards that hold them along the carries'
    chains."""
    S = grp.S

    def own_rows(j, x, t):
        a, m = grp.starts[j], x.shape[1]
        return (rs._rows_batched(x, (t.own_first.long() - a).clamp(0, m - 1)),
                rs._rows_batched(x, (t.own_last.long() - a).clamp(0, m - 1)))

    own = grp.each(own_rows, X, topo)
    N = grp.n
    right = _chain(grp, [(t.own_first < N, o[0]) for t, o in zip(topo, own)],
                   lambda j: X[j][:, -1:].expand(-1, topo[j].own_first.shape[1], -1),
                   lambda carry, mine: torch.where(mine[0][..., None], mine[1], carry), False)
    left = _chain(grp, [(t.own_last >= 0, o[1]) for t, o in zip(topo, own)],
                  lambda j: X[j][:, :1].expand(-1, topo[j].own_last.shape[1], -1),
                  lambda carry, mine: torch.where(mine[0][..., None], mine[1], carry), True)
    return grp.each(lambda j, x, r, l: torch.cat([x, r, l], dim=1), X, right, left)


def read_rows(grp: SpGroup, j: int, ext: torch.Tensor, m: int, t: Topology, target,
              side: str) -> torch.Tensor:
    """Rows of global row ``target (F, n)`` from shard j's extended rows
    (:func:`boundary_tables`, ``m`` own rows): its own where it holds them,
    else the table entry of the row's B (``side`` "right" for targets after
    the shard, "left" before)."""
    a = grp.starts[j]
    V = t.right.shape[1]
    local = (target >= a) & (target < a + m)
    table = m + t.B.long() + (0 if side == "right" else V)
    return rs._rows_batched(ext, torch.where(local, target.long() - a, table))


# -- forward and structure ---------------------------------------------------------


def forward(grp: SpGroup, codes: list, attrs: list, weights: list, depth: int):
    """:func:`raht_span.raht_forward_span_batched` of the shards: per shard
    (coefficients (F, n_j, D), structure)."""
    fdtype = attrs[0].dtype
    D = attrs[0].shape[2]
    topo = topology(grp, codes, depth)
    use_ds = rs._use_ds(fdtype)
    acc_dt = torch.float32 if use_ds else torch.float64

    def body(j, a, w):
        w_acc = w.to(acc_dt)
        return torch.cat([ieee_sqrt(w_acc)[..., None] * a.to(acc_dt), w_acc[..., None]], dim=2)

    SW = packs(grp, grp.each(body, attrs, weights), use_ds)
    total = grp.send(SW[-1][:, -1], grp.devices[0])
    ext = boundary_tables(grp, topo, SW)

    def rows(j, e, t):
        n = grp.sizes[j]
        return rs._forward_rows(
            e[:, :n], read_rows(grp, j, e, n + 1, t, t.next_ge, "right"),
            read_rows(grp, j, e, n + 1, t, t.prev_ge.clamp(min=0), "left"),
            total if j == 0 else None, grp.root(j, e.device), t.drop, D, use_ds, fdtype)

    return grp.each(rows, ext, topo)


def structure(grp: SpGroup, codes: list, weights: list, depth: int) -> list:
    """:func:`raht_span.raht_structure_span_batched` of the shards (the
    decoder's structure pass, equal to :func:`forward`'s)."""
    fdtype = weights[0].dtype
    if rs._use_ds(fdtype):
        topo = topology(grp, codes, depth)
        P = packs(grp, [w.to(torch.float32)[..., None] for w in weights], True)
        total = grp.send(P[-1][:, -1], grp.devices[0])
        ext = boundary_tables(grp, topo, P)

        def rows(j, e, t):
            n = grp.sizes[j]
            w0, w1 = rs._pair_weights_from_pack(
                e[:, :n], read_rows(grp, j, e, n + 1, t, t.next_ge, "right"),
                read_rows(grp, j, e, n + 1, t, t.prev_ge.clamp(min=0), "left"))
            w_total = total[:, 0] + total[:, 1] if j == 0 else None
            return rs._structure_rows(t.drop, w0, w1, w_total, grp.root(j, e.device), fdtype)

        return grp.each(rows, ext, topo)
    W, w_total = weight_prefix(grp, weights, fdtype)
    topo = topology(grp, codes, depth, W, w_total)

    def rows64(j, w, t, wt):
        here = w[:, :grp.sizes[j]]
        return rs._structure_rows(t.drop, here - t.w_prev, t.w_next - here, wt,
                                  grp.root(j, w.device), fdtype)

    return grp.each(rows64, W, topo, w_total)


# -- inverse ------------------------------------------------------------------------


def _pair_coefficients(grp: SpGroup, codes: list, weights: list, depth: int, fdtype):
    """The decoder's topology (W-propagated) and each shard's (a, b) and
    (w0, w1)."""
    W, w_total = weight_prefix(grp, weights, fdtype)
    topo = topology(grp, codes, depth, W, w_total)

    def ab(j, w, t):
        here = w[:, :grp.sizes[j]]
        w0, w1 = here - t.w_prev, t.w_next - here
        return _butterfly_ab(w0, w1) + (w0, w1)

    return topo, grp.each(ab, W, topo), w_total


def crossing_nodes(grp: SpGroup, topo: list) -> list:
    """Each shard's (F, n_j) mask of its crossing nodes: rows whose span
    [prev_ge, next_ge) holds a shard edge (row 0 among them)."""
    return [(t.prev_ge < a) | (t.next_ge > a + n)
            for t, a, n in zip(topo, grp.starts, grp.sizes)]


def _snapshot_plan(grp: SpGroup, topo: list):
    """The crossing nodes' slots: per shard the (F, cap) local rows of its
    crossing nodes (cap = 2V: at most V span either edge), the group's
    (F, S * cap) global row ids sorted per frame (pads last), and the sort
    order of the concatenated per-shard slots."""
    V = topo[0].right.shape[1]
    cap = 2 * V
    pad_row = torch.iinfo(torch.int64).max
    masks = crossing_nodes(grp, topo)

    def compact(j, mask):
        F, n = mask.shape
        pos = torch.cumsum(mask, dim=1) - 1
        slot = torch.where(mask & (pos < cap), pos, torch.full_like(pos, cap))
        local = torch.zeros((F, cap + 1), dtype=torch.int64, device=mask.device)
        local.scatter_(1, slot, torch.arange(n, device=mask.device).expand(F, n))
        used = torch.zeros((F, cap + 1), dtype=torch.bool, device=mask.device)
        used.scatter_(1, slot, mask)
        ids = torch.where(used, local + grp.starts[j], torch.full_like(local, pad_row))
        return local[:, :cap], ids[:, :cap]

    slots = grp.each(compact, masks)
    ids = [s[1] for s in slots]
    plans = []
    for j in range(grp.S):
        with grp.on(j):
            dev = grp.devices[j]
            allids = torch.cat([x if k == j else grp.send(x, dev) for k, x in enumerate(ids)],
                               dim=1)
            sorted_ids, order = torch.sort(allids, dim=1, stable=True)
            plans.append((sorted_ids, order))
    return [s[0] for s in slots], plans


def _inverse_chain(grp: SpGroup, coeffs: list, codes: list, weights: list, depth: int):
    """:func:`raht_span.raht_inverse_span_batched`'s pointer-doubling chain
    over the shards (see the module docstring for what crosses)."""
    fdtype = coeffs[0].dtype
    N = grp.n
    lane_limit = 1 << {torch.float32: 24, torch.float64: 53}[fdtype]
    if N > lane_limit:
        raise NotImplementedError(
            f"{fdtype} chain inverse supports N <= {lane_limit} slots "
            f"(got {N}): pointer lanes ride as exact float values; use "
            "float64 I/O"
        )
    topo, abw, _ = _pair_coefficients(grp, codes, weights, depth, fdtype)
    Z = grp.each(lambda j, T, t, c: rs._chain_lanes(c[0], c[1], T, t.next_ge),
                 coeffs, topo, abw)
    ext = boundary_tables(grp, topo, Z)
    dc = coeffs[0][:, :1, :]
    dcs = [dc if j == 0 else grp.send(dc, grp.devices[j]) for j in range(grp.S)]

    def links(j, e, t, T):
        n = grp.sizes[j]
        p, q = t.prev_ge, t.next_ge
        p_c = torch.clamp(p, min=0).long()
        q_c = torch.clamp(q, max=N - 1).long()
        Zp = read_rows(grp, j, e, n, t, p_c, "left")
        Zq = read_rows(grp, j, e, n, t, q_c, "right")
        root = grp.root(j, e.device)
        if root is None:
            root = torch.zeros((n,), dtype=torch.bool, device=e.device)
        return rs._chain_links(Zp, Zq, p, q, p_c, q_c, dcs[j], root)

    state = grp.each(links, ext, topo, coeffs)
    del ext, Z
    local_slots, plans = _snapshot_plan(grp, topo)
    for _ in range(rs._chain_rounds(topo[0].levels)):
        snaps = grp.each(lambda j, s, sl: (torch.gather(s[1], 1, sl),
                                           rs._rows_batched(s[2], sl),
                                           torch.gather(s[0], 1, sl)), state, local_slots)

        def step(j, s, plan):
            par, g, d = s
            dev = g.device
            a, n = grp.starts[j], grp.sizes[j]
            got = [torch.cat([x if k == j else grp.send(x, dev) for k, x in
                              enumerate(parts)], dim=1)
                   for parts in zip(*snaps)]
            sorted_ids, order = plan
            sg, sd, sp_ = (torch.gather(got[0], 1, order),
                           rs._rows_batched(got[1], order),
                           torch.gather(got[2], 1, order))
            local = (par >= a) & (par < a + n)
            slot = torch.searchsorted(sorted_ids, par)
            at = torch.where(local, par - a, n + slot)
            gp = torch.gather(torch.cat([g, sg], dim=1), 1, at)
            dp = rs._rows_batched(torch.cat([d, sd], dim=1), at)
            pp = torch.gather(torch.cat([par, sp_], dim=1), 1, at)
            g, d, par = rs._chain_round(g, d, par, gp, dp, pp)
            return par, g, d

        state = grp.each(step, state, plans)

    def halves(j, s, c, T):
        return rs._chain_halves(c[0], c[1], s[2], T)

    xs = grp.each(halves, state, abw, coeffs)

    def leaves(j, x, s, t):
        x0, x1 = x
        dev = x0.device
        F, n = t.prev_ge.shape
        a = grp.starts[j]
        own = t.prev_ge[:, 1:] == grp.rows(j, dev)[:-1].to(t.prev_ge.dtype)
        if j + 1 < grp.S:
            nxt_prev = grp.send(topo[j + 1].prev_ge[:, :1], dev)
            last = nxt_prev == a + n - 1
            x0_last = grp.send(xs[j + 1][0][:, :1], dev)
        else:
            last = torch.zeros((F, 1), dtype=torch.bool, device=dev)
            x0_last = x0[:, -1:]
        nxt_is_child = torch.cat([own, last], dim=1)
        x0_next = torch.cat([x0[:, 1:], x0_last], dim=1)
        root = grp.root(j, dev)
        if root is None:
            root = torch.zeros((n,), dtype=torch.bool, device=dev)
        return rs._chain_leaves(x0_next, x1, s[2], nxt_is_child, root).to(fdtype)

    return grp.each(leaves, xs, state, topo)


def _inverse_fill(grp: SpGroup, coeffs: list, codes: list, weights: list, depth: int):
    """:func:`raht_span._raht_inverse_span_fill` of every frame over the
    shards: a leaf's v (u) term at a level comes from the nearest row at or
    before (at or after) it with B >= v, read from the boundary tables of
    the terms (and B) where that row lies in another shard; the u terms'
    one-row shift crosses as a halo."""
    fdtype = coeffs[0].dtype
    acc_dt = torch.float64 if fdtype == torch.float64 else torch.float32
    N = grp.n
    topo, abw, w_total = _pair_coefficients(grp, codes, weights, depth, fdtype)
    V = topo[0].right.shape[1]
    D = coeffs[0].shape[2]

    def terms(j, c, T, t):
        a, b, w0, w1 = c
        Ta = T.to(acc_dt)
        not0 = (grp.rows(j, T.device) != 0).to(acc_dt)[:, None]
        u = ((-b).to(acc_dt) * rs._inv_root(w0, acc_dt))[..., None] * Ta * not0
        v = (a.to(acc_dt) * rs._inv_root(w1, acc_dt))[..., None] * Ta * not0
        return torch.cat([u, v, t.B.to(acc_dt)[..., None]], dim=2)

    X = grp.each(terms, abw, coeffs, topo)
    ext = boundary_tables(grp, topo, X)

    def sums(j, e, t):
        n, a = grp.sizes[j], grp.starts[j]
        dev = e.device
        F = e.shape[0]
        vals = torch.arange(V, dtype=t.B.dtype, device=dev)
        idx = grp.rows(j, dev).to(torch.int32)
        ge = t.B[:, None, :] >= vals[None, :, None]                     # (F, V, n)
        last = torch.cummax(torch.where(ge, idx, torch.full_like(idx, -1)), dim=2).values
        nxt = torch.cummin(torch.where(ge, idx, torch.full_like(idx, N)).flip(2),
                           dim=2).values.flip(2)
        last = torch.maximum(last, t.left[..., None])
        nxt = torch.minimum(nxt, t.right[..., None])
        table = torch.arange(V, device=dev)[None, :, None]
        at_v = torch.where(last >= a, last.long() - a, n + V + table)
        at_u = torch.where(nxt < a + n, nxt.long() - a, n + table)
        out = []
        for f in range(F):
            u, v, Bf = e[f, :, :D], e[f, :, D:2 * D], e[f, :, 2 * D]
            hit_v = (last[f] >= 0) & (Bf[at_v[f]] == vals[:, None])
            hit_u = (nxt[f] < N) & (Bf[at_u[f]] == vals[:, None])
            out.append((rs._level_sums(v, at_v[f], hit_v), rs._level_sums(u, at_u[f], hit_u)))
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    S_ = grp.each(sums, ext, topo)
    del ext
    dc0 = coeffs[0][:, 0].to(acc_dt)

    def finish(j, s, w, wt):
        v_sum, u_incl = s
        dev = v_sum.device
        F = v_sum.shape[0]
        if j + 1 < grp.S:
            u_next = grp.send(S_[j + 1][1][:, :1], dev)
        else:
            u_next = torch.zeros((F, 1, D), dtype=acc_dt, device=dev)
        u_sum = torch.cat([u_incl[:, 1:], u_next], dim=1)
        w_root = ieee_sqrt(torch.where(wt > 0, wt, torch.ones_like(wt)))
        T0 = dc0 if j == 0 else grp.send(dc0, dev)
        dc_term = T0 / w_root.to(acc_dt)[:, None]
        out = (v_sum + u_sum + dc_term[:, None, :]) * ieee_sqrt(w.to(acc_dt))[..., None]
        return out.to(fdtype)

    return grp.each(finish, S_, weights, w_total)


def inverse(grp: SpGroup, coeffs: list, codes: list, weights: list, depth: int) -> list:
    """:func:`raht_span.raht_inverse_span_batched` of the shards:
    ``RAHT3DGS_SPAN_INVERSE`` (read per call) picks the chain or the fill."""
    if os.environ.get("RAHT3DGS_SPAN_INVERSE", "chain") == "fill":
        return _inverse_fill(grp, coeffs, codes, weights, depth)
    return _inverse_chain(grp, coeffs, codes, weights, depth)


# -- stream orders ---------------------------------------------------------------------


def stream_positions(grp: SpGroup, structures: list, nvox: list, order_mode: str,
                     depth: int) -> list:
    """Each shard's (F, n_j) int64 stream positions of its rows under the
    pads-last coefficient order (:func:`parallel.sharding.batched_inverse_order`'s
    output), ``nvox`` each shard's (F,) real voxel counts. For ``ragft``
    and ``morton``: the rows with a smaller (pad, key) on any shard, plus
    those with an equal one on earlier shards, plus the row's stable rank
    in its shard, from the shards' (F, 2 * n_keys) key histograms (and the
    frames' largest RA-GFT group) sent to every shard. For
    ``weight_desc``: one stable argsort of the node weight column gathered
    on the first shard, its positions sent back."""
    if order_mode == "weight_desc":
        return _positions_weight_desc(grp, structures, nvox)
    drops = [s.drop_level for s in structures]
    if order_mode == "ragft":
        groups = [torch.div(d + 2, 3, rounding_mode="floor") for d in drops]
        gmax = [g.amax(dim=1) for g in groups]
        gmax_all = [torch.stack([x if k == j else grp.send(x, grp.devices[j])
                                 for k, x in enumerate(gmax)]).amax(dim=0)
                    for j in range(grp.S)]
        keys = [torch.where(d == 0, torch.zeros_like(g), 1 + gm[:, None] - g)
                for d, g, gm in zip(drops, groups, gmax_all)]
        # drop <= levels + 2, so key <= 1 + (levels + 4) // 3
        n_keys = (num_levels(depth, grp.n) + 4) // 3 + 2
    elif order_mode == "morton":
        keys = [torch.zeros_like(d) for d in drops]
        n_keys = 1
    else:
        raise ValueError(f"unknown order mode {order_mode!r}")

    def composite(j, key, nv):
        pad = grp.rows(j, key.device)[None, :] >= nv[:, None]
        return key.long() + pad.long() * n_keys

    ck = grp.each(composite, keys, nvox)
    hists = grp.each(lambda j, c: torch.zeros((c.shape[0], 2 * n_keys), dtype=torch.int64,
                                              device=c.device).scatter_add_(
        1, c, torch.ones_like(c)), ck)

    def place(j, c, h):
        dev = c.device
        H = torch.stack([x if k == j else grp.send(x, dev) for k, x in enumerate(hists)])
        total = H.sum(dim=0)                                   # (F, C)
        below = torch.cumsum(total, dim=1) - total
        before = H[:j].sum(dim=0) if j else torch.zeros_like(total)
        perm = torch.argsort(c, dim=1, stable=True)
        sk = torch.gather(c, 1, perm)
        start = torch.cumsum(h, dim=1) - h
        rank = torch.arange(c.shape[1], device=dev)[None, :] - torch.gather(start, 1, sk)
        pos = torch.gather(below + before, 1, sk) + rank
        return torch.empty_like(pos).scatter_(1, perm, pos)

    return grp.each(place, ck, hists)


def _positions_weight_desc(grp: SpGroup, structures: list, nvox: list) -> list:
    """``weight_desc`` stream positions: the node weights of every shard on
    the first shard, ``_pads_last_batched`` of their stable descending
    argsort there, and its inverse's slices sent back."""
    dev0 = grp.devices[0]
    w = torch.cat([s.node_weights if j == 0 else grp.send(s.node_weights, dev0)
                   for j, s in enumerate(structures)], dim=1)
    with grp.on(0):
        order = torch.argsort(-w, dim=1, stable=True)
        pads = (order >= nvox[0][:, None]).to(torch.int8)
        order2 = torch.gather(order, 1, torch.argsort(pads, dim=1, stable=True))
        inv = torch.argsort(order2, dim=1, stable=True).to(torch.int32)
    out = []
    for j in range(grp.S):
        part = inv[:, grp.starts[j]:grp.starts[j] + grp.sizes[j]]
        out.append((part if j == 0 else grp.send(part, grp.devices[j])).long())
    return out


# -- the roundtrip's squared error -------------------------------------------------


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise tree (padded with zeros
    to a power of two), so the association depends on the length alone, on
    any device and any leading shape."""
    L = x.shape[-1]
    width = 1 << max(L - 1, 0).bit_length()
    if width > L:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (width - L,))], dim=-1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def block_sums(sq: torch.Tensor) -> torch.Tensor:
    """(F, n, D) squared errors -> (F, D, T) sums of the TILE-row blocks
    (the last one zero-padded), each a :func:`tree_sum`."""
    F, n, D = sq.shape
    T = -(-n // TILE)
    if T * TILE > n:
        sq = torch.cat([sq, sq.new_zeros((F, T * TILE - n, D))], dim=1)
    return tree_sum(sq.reshape(F, T, TILE, D).permute(0, 3, 1, 2))


def squared_error_sums(grp: SpGroup, sq: list) -> torch.Tensor:
    """The unsharded ``tree_sum(block_sums(sq))`` of the shards' (F, n_j, D)
    squared errors, (F, D) on shard 0's device: each TILE-row block summed
    by the shard holding its first row (the block's rows in later shards
    cross as a halo), the block sums gathered on shard 0."""
    plans = shard_plan(grp.sizes, TILE)
    dev0 = grp.devices[0]
    parts = []
    for j, p in enumerate(plans):
        if not p.tiles:
            continue
        with grp.on(j):
            rows = torch.cat([sq[j][:, p.lead:]] + halo(sq, plans, j, grp.send), dim=1)
            got = block_sums(rows)
            parts.append(got if j == 0 else grp.send(got, dev0))
    return tree_sum(torch.cat(parts, dim=2))
