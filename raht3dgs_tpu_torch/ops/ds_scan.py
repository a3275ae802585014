"""Double-single (hi, lo) compensated prefix sums: the CUDA kernel and its
plain PyTorch version.

Counterpart of ``raht3dgs_tpu/ops/pallas_scan.py`` (``ds_cumsum_pallas``
and ``ds_cumsum_pallas_t``). The kernel is ``csrc/ds_scan.cu``, with two
entries: one matrix, and a (B, N, K) stack of frames (the TPU kernel under
``jax.vmap``). It is built with nvcc for ``sm_90a`` into ``_build/`` at
first use and called through ctypes on PyTorch's current stream of the
tensor's device, with that device made current for the launch (the
kernel's shared-memory opt-in is per device). The
wrappers take the plain version only for a tensor that lies on the CPU;
for a CUDA tensor they launch the kernel or raise. :func:`ds_prefix_pack`
gives the codec's prefix pack (a zero row, then ``[hi | lo]``), which on
the card the kernel writes itself. Both take any number of columns K in
one call: up to 8 columns a block scans a whole tile; wider rows (the 3DGS
transform's (N, 57) pack, the Gaussian merge's (N, 60) sums) take the wide
path of ``csrc/ds_scan.cu``, column blocks of 8 whose blocks of one tile
run side by side, each staging its slice with ``cp.async`` and scanning
it from shared memory at two blocks an SM, with the same adds per column.
``scripts/scan_phase_probe.py`` splits the wide path's time on the card.
:func:`ds_cumsum_batched` and :func:`ds_prefix_pack_batched` scan every
frame of a stack; frame b's result is the single entry's on ``x[b]``, bit
for bit. Up to 8 columns and 2 to 2048 tiles a frame, that is one pass
over the stack: each block takes its tile from a ticket counter, reads it
once, publishes its total and combines the totals of the tiles before it
in the single entry's fixed order. :func:`ds_prefix_pack_sharded`
scans a matrix or a stack whose rows lie in shards on several devices
(``parallel/sp_span.py``'s sp axis), each shard its own tiles, with only
halos, tile totals and leading rows crossing; every shard's pack is its
rows of the unsharded pack, bit for bit (the plain version's, of the plain
pack).

Both the kernel and :func:`ds_cumsum_reference` keep ~48 mantissa bits
(error-free two-sum) and give exact results for integer-valued lanes whose
partial sums stay below 2^24 — under their own association, which differs
between the two, so float lanes agree to ~1e-12 relative, not bitwise.
"""

from __future__ import annotations

import ctypes
import os
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from raht3dgs_tpu_torch.codec._native import NativeLib, nvcc_command

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc", "ds_scan.cu",
)


def _configure(lib: ctypes.CDLL) -> None:
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ds_cumsum_f32.argtypes = [vp, ll, i32, ll, ll, i32, vp, vp, ll, vp]
    lib.ds_cumsum_f32.restype = i32
    lib.ds_cumsum_batched_f32.argtypes = [vp, ll, ll, i32, i32, vp, vp, ll, vp]
    lib.ds_cumsum_batched_f32.restype = i32
    lib.ds_shard_totals_f32.argtypes = [vp, ll, ll, ll, i32, ll, vp, ll, vp, vp]
    lib.ds_shard_totals_f32.restype = i32
    lib.ds_shard_scan_f32.argtypes = [vp, ll, ll, ll, i32, ll, ll, vp, ll, vp, ll, vp, ll,
                                      vp, ll, vp]
    lib.ds_shard_scan_f32.restype = i32


KERNEL = NativeLib(_SRC, "libds_scan.so", _configure, nvcc_command)

TILE = 2048             # rows per block (kTile in csrc/ds_scan.cu)
MAX_CARRY_TILES = 2048  # tile totals one block combines (kMaxCarryTiles)
MAX_FRAMES = 65535      # frames of one batched launch (the grid's z extent)


def scratch_floats(n: int, k: int) -> int:
    """Floats of scratch the kernel needs for ``n`` rows of ``k`` columns:
    the tile totals (hi, lo), and beyond ``MAX_CARRY_TILES`` tiles also
    their scan and the next level's scratch. The kernel counts the same
    (``scratch_need``) and refuses to launch with less."""
    t = -(-n // TILE)
    if t <= 1:
        return 0
    if t <= MAX_CARRY_TILES:
        return 2 * t * k
    return 4 * t * k + scratch_floats(t, k)


def batched_scratch_floats(b: int, n: int, k: int) -> int:
    """Floats of scratch the batched entry needs for ``b`` frames of ``n``
    rows of ``k`` columns. Where one launch scans the stack (2 <= ``k`` <=
    8, 2 to ``MAX_CARRY_TILES`` tiles a frame): a record a tile of its (hi,
    lo) totals, 2k floats, each frame's rounded up to a multiple of 4
    floats, after up to 3 floats that align the records to 16 bytes; then a
    flag a tile and one ticket counter. Otherwise :func:`scratch_floats` a
    frame. The kernel counts the same (``batched_scratch_need``) and
    refuses to launch with less."""
    t = -(-n // TILE)
    if 2 <= k <= 8 and 2 <= t <= MAX_CARRY_TILES:
        return b * (-(-2 * t * k // 4) * 4) + 3 + b * t + 1
    return b * scratch_floats(n, k)


# Kernel launches per entry point. Each wrapper adds one where it launches
# the kernel and nowhere else; callers reset and read them.
LAUNCHES = {"ds_cumsum": 0, "ds_cumsum_t": 0, "ds_cumsum_batched": 0,
            "ds_cumsum_sharded": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- plain version ------------------------------------------------------------


def _ds_add(h1, l1, h2, l2):
    """(h1, l1) + (h2, l2) in double-single, one IEEE op per line."""
    s = h1 + h2
    bv = s - h1
    err = (h1 - (s - bv)) + (h2 - bv)
    e = err + (l1 + l2)
    hi = s + e
    lo = e - (hi - s)
    return hi, lo


PLAIN_BLOCK = 256       # rows per block of the plain version


def _block_scans(hi, lo, block: int, padded: bool):
    """Sequential ds scans inside the ``block``-row blocks of an (M, K)
    (hi, lo) pair, vectorized over blocks: (nb, block, K) each. ``padded``
    (a scan of more than one block): the last block is filled out with
    zero rows, whose adds give its total; otherwise one block of M rows."""
    M, K = hi.shape
    if not padded:
        vh, vl, nb, width = hi[None], lo[None], 1, M
    else:
        nb, width = -(-M // block), block
        pad = torch.zeros(nb * block - M, K, dtype=hi.dtype, device=hi.device)
        vh = torch.cat([hi, pad]).reshape(nb, block, K)
        vl = torch.cat([lo, pad]).reshape(nb, block, K)
    oh = torch.empty_like(vh)
    ol = torch.empty_like(vl)
    rh = torch.zeros(nb, K, dtype=hi.dtype, device=hi.device)
    rl = torch.zeros_like(rh)
    for j in range(width):
        rh, rl = _ds_add(rh, rl, vh[:, j], vl[:, j])
        oh[:, j] = rh
        ol[:, j] = rl
    return oh, ol


def _block_carries(th, tl, block: int):
    """The carry in front of each block from the (T, K) block totals: the
    exclusive ds scan of the totals (the plain scan itself), (T, 1, K)."""
    ch, cl = _ds_scan_plain(th, tl, block)
    zrow = torch.zeros(1, th.shape[1], dtype=th.dtype, device=th.device)
    return torch.cat([zrow, ch[:-1]])[:, None], torch.cat([zrow, cl[:-1]])[:, None]


def _ds_scan_plain(hi, lo, block: int = PLAIN_BLOCK):
    """Inclusive ds scan along dim 0 of an (N, K) (hi, lo) pair: a sequential
    scan inside ``block``-row blocks (vectorized over blocks), the same scan
    applied to the block totals, and one combine."""
    N, K = hi.shape
    oh, ol = _block_scans(hi, lo, block, N > block)
    if N > block:
        ch, cl = _block_carries(oh[:, -1], ol[:, -1], block)
        oh, ol = _ds_add(ch, cl, oh, ol)
    return oh.reshape(-1, K)[:N], ol.reshape(-1, K)[:N]


def ds_cumsum_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`ds_cumsum` on any device."""
    _check(x)
    return _ds_scan_plain(x, torch.zeros_like(x))


def ds_prefix_pack_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`ds_prefix_pack` on any device."""
    hi, lo = ds_cumsum_reference(x)
    P = torch.cat([hi, lo], dim=1)
    return torch.cat([P.new_zeros((1, P.shape[1])), P])


def ds_cumsum_batched_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`ds_cumsum_batched` on any device:
    every frame's columns side by side in one (N, B*K) plain scan, whose
    adds are per column, so frame b's result is
    ``ds_cumsum_reference(x[b])`` bit for bit."""
    _check_batched(x)
    B, N, K = x.shape
    cols = x.permute(1, 0, 2).reshape(N, B * K)
    hi, lo = _ds_scan_plain(cols, torch.zeros_like(cols))
    return tuple(t.reshape(N, B, K).permute(1, 0, 2).contiguous() for t in (hi, lo))


def ds_prefix_pack_batched_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`ds_prefix_pack_batched`."""
    hi, lo = ds_cumsum_batched_reference(x)
    P = torch.cat([hi, lo], dim=2)
    return torch.cat([P.new_zeros((P.shape[0], 1, P.shape[2])), P], dim=1)


# -- kernel wrappers ------------------------------------------------------------


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"ds scan takes float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"ds scan takes a 2-D tensor, got shape {tuple(x.shape)}")


def _check_batched(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"ds scan takes float32, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"batched ds scan takes a (B, N, K) tensor, got shape "
                         f"{tuple(x.shape)}")


def _launch(x: torch.Tensor, n: int, k: int, rs: int, cs: int, entry: str,
            pack: bool = False):
    """Launch the kernel on ``x`` (element (r, c) at ``x[r*rs + c*cs]``).

    Returns ``(hi, lo)`` in ``x``'s layout, or with ``pack`` the
    ``(n+1, 2k)`` matrix ``[0; hi | lo]`` written by the kernel itself. One
    allocation holds the outputs and the kernel's scratch. The launch runs
    with ``x``'s device current, on that device's current stream: the
    kernel's shared-memory opt-in binds to the current device."""
    if k < 1:
        raise ValueError(f"ds scan kernel takes at least one column, got {k}")
    if not x.is_contiguous():
        raise ValueError("ds scan kernel takes a contiguous tensor")
    if x.device.type != "cuda":
        raise ValueError(f"ds scan kernel needs a CUDA tensor, got {x.device}")
    if x.get_device() != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _launch(x, n, k, rs, cs, entry, pack)
    lib = KERNEL.load()
    if n == 0:
        if pack:
            return x.new_zeros((1, 2 * k))
        return x.new_empty(x.shape), x.new_empty(x.shape)
    # one allocation: the outputs' rows, then rows enough for the scratch
    rows, width = (n + 1, 2 * k) if pack else (2 * x.shape[0], x.shape[1])
    buf = x.new_empty((rows + -(-scratch_floats(n, k) // width), width))
    out = buf.data_ptr()
    # the raw handle of PyTorch's current stream (torch.cuda.current_stream
    # builds a Stream object first, ~5 us a call)
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    rc = lib.ds_cumsum_f32(x.data_ptr(), n, k, rs, cs, int(pack), out,
                           out + 4 * rows * width, buf.numel() - rows * width,
                           stream)
    if rc != 0:
        raise RuntimeError(f"ds_cumsum_f32 launch failed (code {rc})")
    LAUNCHES[entry] += 1
    if pack:
        return buf[:rows]
    hi, lo, *_ = buf.split(x.shape[0])
    return hi, lo


def _row_entry(k: int) -> str:
    # a single column is the same memory in both layouts and counts as the
    # transposed entry, which the decoder's one-column scans are
    return "ds_cumsum_t" if k == 1 else "ds_cumsum"


def ds_cumsum(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compensated inclusive prefix sums along dim 0 of ``x (N, K)`` f32.

    Returns ``(hi, lo)`` float32 (N, K)."""
    _check(x)
    if x.device.type == "cpu":
        return ds_cumsum_reference(x)
    N, K = x.shape
    return _launch(x, N, K, K, 1, _row_entry(K))


def ds_cumsum_t(xt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transposed entry: ``xt (K, N)`` f32, scanned along the last axis;
    returns ``(hi, lo)`` in the same (K, N) layout."""
    _check(xt)
    if xt.device.type == "cpu":
        hi, lo = ds_cumsum_reference(xt.T)
        return hi.T.contiguous(), lo.T.contiguous()
    K, N = xt.shape
    return _launch(xt, N, K, 1, N, "ds_cumsum_t")


def ds_prefix_pack(x: torch.Tensor) -> torch.Tensor:
    """``x (N, K)`` f32 -> ``(N+1, 2K)``: a zero row, then :func:`ds_cumsum`'s
    ``[hi | lo]``. On a CUDA tensor the kernel writes the pack itself."""
    _check(x)
    if x.device.type == "cpu":
        return ds_prefix_pack_reference(x)
    N, K = x.shape
    return _launch(x, N, K, K, 1, _row_entry(K), pack=True)


def _launch_batched(x: torch.Tensor, pack: bool):
    """Launch the batched entry on the (B, N, K) stack ``x``: ``(hi, lo)``
    as (B, N, K) views of one (B, 2, N, K) block, or with ``pack`` the
    (B, N + 1, 2K) stack of packs. One allocation holds the outputs and
    every frame's scratch. Runs with ``x``'s device current, as
    :func:`_launch` does."""
    B, N, K = x.shape
    if K < 1:
        raise ValueError(f"ds scan kernel takes at least one column, got {K}")
    if not x.is_contiguous():
        raise ValueError("ds scan kernel takes a contiguous tensor")
    if x.device.type != "cuda":
        raise ValueError(f"ds scan kernel needs a CUDA tensor, got {x.device}")
    if B > MAX_FRAMES:
        raise ValueError(f"batched ds scan takes at most {MAX_FRAMES} frames, got {B}")
    if x.get_device() != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _launch_batched(x, pack)
    lib = KERNEL.load()
    if B == 0 or N == 0:
        if pack:
            return x.new_zeros((B, N + 1, 2 * K))
        return x.new_empty(x.shape), x.new_empty(x.shape)
    per = (N + 1) * 2 * K if pack else 2 * N * K
    scratch = batched_scratch_floats(B, N, K)
    buf = x.new_empty(B * per + scratch)
    out = buf.data_ptr()
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    rc = lib.ds_cumsum_batched_f32(x.data_ptr(), B, N, K, int(pack), out,
                                   out + 4 * B * per, scratch, stream)
    if rc != 0:
        raise RuntimeError(f"ds_cumsum_batched_f32 launch failed (code {rc})")
    LAUNCHES["ds_cumsum_batched"] += 1
    if pack:
        return buf[:B * per].view(B, N + 1, 2 * K)
    hl = buf[:B * per].view(B, 2, N, K)
    return hl[:, 0], hl[:, 1]


def ds_cumsum_batched(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ds_cumsum` of every frame of ``x (B, N, K)`` f32, in one
    launch for the whole stack where 2 <= K <= 8 and a frame holds 2 to
    ``MAX_CARRY_TILES`` tiles (otherwise one launch per pass of the
    kernel). Returns ``(hi, lo)``, each (B, N, K)."""
    _check_batched(x)
    if x.device.type == "cpu":
        return ds_cumsum_batched_reference(x)
    return _launch_batched(x, pack=False)


def ds_prefix_pack_batched(x: torch.Tensor) -> torch.Tensor:
    """:func:`ds_prefix_pack` of every frame of ``x (B, N, K)`` f32: the
    (B, N + 1, 2K) stack of packs, written by the kernel on the card."""
    _check_batched(x)
    if x.device.type == "cpu":
        return ds_prefix_pack_batched_reference(x)
    return _launch_batched(x, pack=True)


# -- the sharded entry: a matrix (or stack) whose rows lie in shards ----------
#
# Shard j holds rows [a_j, a_j + n_j) of an N-row matrix, each shard on its
# own device. Tile t (``tile`` rows: the kernel's TILE, the plain version's
# PLAIN_BLOCK) is owned by the shard that holds its first row. A shard
# receives the rows of its last owned tile that lie in the shards after it
# (its halo, fewer than ``tile``), computes its owned tiles' totals, takes
# every shard's totals (T x K x (hi, lo)), scans its tiles with the carries
# of the whole scan, and sends the halo's scanned rows back. Only halos,
# totals, returned rows and each shard's leading pack row cross; ``send``
# moves them (and counts them, for a caller that tallies the exchange).
# Both versions give, on every shard, the bits of the unsharded call on the
# whole matrix.


class ShardPlan(NamedTuple):
    """Shard j's part of a sharded scan."""
    start: int      # its first row, a_j
    rows: int       # n_j
    tile0: int      # its first owned tile
    tiles: int      # tiles it owns
    lead: int       # its rows before its first owned tile
    halo: int       # rows of its last owned tile in the shards after it


def shard_plan(sizes: Sequence[int], tile: int) -> List[ShardPlan]:
    """Owned tiles, leading rows and halos of shards of ``sizes`` rows."""
    total = sum(sizes)
    plans, a = [], 0
    for n in sizes:
        t0, t1 = -(-a // tile), -(-(a + n) // tile)
        tiles = max(t1 - t0, 0)
        halo = max(min(t1 * tile, total) - (a + n), 0) if tiles else 0
        plans.append(ShardPlan(a, n, t0, tiles, min(t0 * tile - a, n), halo))
        a += n
    return plans


def _plain_send(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t.to(dev)


def halo(xs: Sequence[torch.Tensor], plans: Sequence[ShardPlan], j: int,
         send: Callable = _plain_send) -> List[torch.Tensor]:
    """Shard j's halo: the first rows (dim 1) of the shards after it that
    its last owned tile holds, each sent to shard j's device."""
    parts, need, k = [], plans[j].halo, j + 1
    while need:
        take = min(need, plans[k].rows)
        parts.append(send(xs[k][:, :take], xs[j].device))
        need, k = need - take, k + 1
    return parts


def _sharded_pack(xs, tile: int, pass1, pass2, send) -> List[torch.Tensor]:
    """The exchange and bookkeeping of both versions of the sharded pack.
    ``xs`` are (B, n_j, K) float32. ``pass1(x, plan, grid_tail, T)`` gives
    a shard's (B, 2, tiles, K) totals and a state; ``pass2(x, plan,
    grid_tail, T, totals, state)`` its (B, n_j + 1, 2K) pack with the rows
    of its owned tiles inside the shard written, and the scanned rows from
    global row ``first`` on as (first, (B, r, 2K)), r covering the halo."""
    plans = shard_plan([x.shape[1] for x in xs], tile)
    N = sum(p.rows for p in plans)
    T = -(-N // tile)
    # the last owned tile's rows, own then halo (the halo: the next shards'
    # first rows)
    tails = []
    for j, (x, p) in enumerate(zip(xs, plans)):
        last = (p.tile0 + p.tiles - 1) * tile - p.start
        tails.append(torch.cat([x[:, last:]] + halo(xs, plans, j, send), dim=1).contiguous()
                     if p.halo else None)
    owners = [j for j, p in enumerate(plans) if p.tiles]
    states = {j: pass1(xs[j], plans[j], tails[j], T) for j in owners}
    packs = [None] * len(xs)
    spill = []
    for j in owners:
        x = xs[j]
        totals = None
        if T > 1:
            totals = torch.cat([states[k][0] if k == j else send(states[k][0], x.device)
                                for k in owners], dim=2)
        packs[j], extra = pass2(x, plans[j], tails[j], T, totals, states[j][1])
        spill.append((j,) + extra)
    B, K = xs[0].shape[0], xs[0].shape[2]
    for j, (x, p) in enumerate(zip(xs, plans)):
        if packs[j] is None:
            packs[j] = x.new_empty((B, p.rows + 1, 2 * K))
    # scanned rows of a tile that runs past its owner: back to their shards
    for j, first, rows in spill:
        for k, p in enumerate(plans):
            lo, hi = max(first, p.start), min(first + rows.shape[1], p.start + p.rows)
            if lo < hi:
                part = rows[:, lo - first:hi - first]
                packs[k][:, 1 + lo - p.start:1 + hi - p.start] = \
                    part if k == j else send(part, packs[k].device)
    # the leading rows: the inclusive prefix at the row before each shard
    packs[0][:, 0] = 0.0
    for j in range(1, len(packs)):
        packs[j][:, 0] = send(packs[j - 1][:, -1], packs[j].device)
    return packs


def _plain_pass1(x, p: ShardPlan, tail, T: int):
    B, _, K = x.shape
    grid = x[:, p.lead:] if tail is None else torch.cat(
        [x[:, p.lead:(p.tile0 + p.tiles - 1) * PLAIN_BLOCK - p.start], tail], dim=1)
    m = grid.shape[1]
    cols = grid.permute(1, 0, 2).reshape(m, B * K)
    oh, ol = _block_scans(cols, torch.zeros_like(cols), PLAIN_BLOCK, T > 1)
    tot = torch.stack([oh[:, -1], ol[:, -1]]).reshape(2, p.tiles, B, K).permute(2, 0, 1, 3)
    return tot.contiguous(), (oh, ol, m)


def _plain_pass2(x, p: ShardPlan, tail, T: int, totals, state):
    B, n, K = x.shape
    oh, ol, m = state
    if T > 1:
        th = totals[:, 0].permute(1, 0, 2).reshape(T, B * K)
        tl = totals[:, 1].permute(1, 0, 2).reshape(T, B * K)
        ch, cl = _block_carries(th, tl, PLAIN_BLOCK)
        sl = slice(p.tile0, p.tile0 + p.tiles)
        oh, ol = _ds_add(ch[sl], cl[sl], oh, ol)
    rows = [t.reshape(-1, B, K)[:m].permute(1, 0, 2) for t in (oh, ol)]
    rows = torch.cat(rows, dim=2)                       # (B, m, 2K)
    pack = x.new_empty((B, n + 1, 2 * K))
    own = n - p.lead
    pack[:, 1 + p.lead:] = rows[:, :own]
    return pack, (p.start + n, rows[:, own:])


def ds_prefix_pack_sharded_reference(xs: Sequence[torch.Tensor],
                                     send: Optional[Callable] = None) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`ds_prefix_pack_sharded` on any
    device: the plain version's 256-row blocks owned and carried as the
    kernel's tiles are, so each shard's pack is bitwise its rows of
    :func:`ds_prefix_pack_reference` (:func:`ds_prefix_pack_batched_reference`)
    on the whole."""
    xs3, single = _as_stack(xs)
    packs = _sharded_pack(xs3, PLAIN_BLOCK, _plain_pass1, _plain_pass2, send or _plain_send)
    return [q[0] for q in packs] if single else packs


def _as_stack(xs):
    xs = list(xs)
    if not xs:
        raise ValueError("a sharded scan takes at least one shard")
    single = xs[0].dim() == 2
    for x in xs:
        (_check if single else _check_batched)(x)
    xs3 = [x[None] if single else x for x in xs]
    if len({(x.shape[0], x.shape[2]) for x in xs3}) != 1:
        raise ValueError("the shards of a sharded scan differ in frames or columns: "
                         f"{[tuple(x.shape) for x in xs]}")
    return xs3, single


def _kernel_pass1(x, p: ShardPlan, tail, T: int):
    B, n, K = x.shape
    m = n - p.lead + p.halo
    tot = x.new_empty((B, 2, p.tiles, K))
    lib = KERNEL.load()
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    rc = lib.ds_shard_totals_f32(x.data_ptr() + 4 * p.lead * K, B, n * K, m, K, T,
                                 None if tail is None else tail.data_ptr(),
                                 0 if tail is None else tail.shape[1] * K,
                                 tot.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ds_shard_totals_f32 launch failed (code {rc})")
    return tot, None


def _kernel_pass2(x, p: ShardPlan, tail, T: int, totals, state):
    B, n, K = x.shape
    m = n - p.lead + p.halo
    need = scratch_floats(T * TILE, K)
    scratch = x.new_empty((B, max(need, 1)))
    if totals is not None:
        scratch[:, :2 * T * K] = totals.reshape(B, 2 * T * K)
    pack = x.new_empty((B, n + 1, 2 * K))
    tail_out = None if tail is None else x.new_empty((B, tail.shape[1], 2 * K))
    lib = KERNEL.load()
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    rc = lib.ds_shard_scan_f32(
        x.data_ptr() + 4 * p.lead * K, B, n * K, m, K, p.tile0, T,
        None if tail is None else tail.data_ptr(), 0 if tail is None else tail.shape[1] * K,
        pack.data_ptr() + 4 * p.lead * 2 * K, (n + 1) * 2 * K,
        None if tail is None else tail_out.data_ptr(),
        0 if tail is None else tail.shape[1] * 2 * K,
        scratch.data_ptr(), scratch.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"ds_shard_scan_f32 launch failed (code {rc})")
    LAUNCHES["ds_cumsum_sharded"] += 1
    if tail is None:
        return pack, (p.start + n, pack[:, :0])
    return pack, ((p.tile0 + p.tiles - 1) * TILE, tail_out)


def _kernel_pass(fn):
    """``fn`` with the shard's device current (the kernels' shared-memory
    opt-in binds to the current device)."""
    def run(x, *args):
        with torch.cuda.device(x.device):
            return fn(x, *args)
    return run


def ds_prefix_pack_sharded(xs: Sequence[torch.Tensor],
                           send: Optional[Callable] = None) -> List[torch.Tensor]:
    """The prefix pack of a matrix (or a stack of frames) whose rows lie in
    shards, each shard on its own device: ``xs`` the shards in row order,
    each (n_j, K) or (B, n_j, K) float32 and contiguous. Returns each
    shard's (n_j + 1, 2K) or (B, n_j + 1, 2K) pack: the inclusive prefix at
    the row before its first (zeros for the first shard), then its rows
    ``[hi | lo]``, bitwise rows a_j .. a_j + n_j of :func:`ds_prefix_pack`
    (:func:`ds_prefix_pack_batched`) on the whole. ``send(t, device)`` moves
    what crosses between shards (``t.to(device)`` by default): for F frames
    of K columns over S shards, 4FK (3H + 2(O - 1)T + 2(S - 1)) bytes, H the
    halo rows (in, and their [hi | lo] rows back), O the shards that own a
    tile and T the tiles (every owner takes the others' (hi, lo) totals;
    nothing for one tile), and each shard's leading row. Tiles are TILE rows
    on the card, PLAIN_BLOCK in the plain version.

    CUDA shards run the kernel's sharded entry (pass 1 and pass 2 of
    ``csrc/ds_scan.cu`` a shard, each shard's launches on its device's
    current stream; a shard's two passes count as one launch); CPU shards
    the plain version. A mix of the two raises."""
    xs3, single = _as_stack(xs)
    kinds = {x.device.type for x in xs3}
    if kinds == {"cpu"}:
        return ds_prefix_pack_sharded_reference(xs, send)
    if kinds != {"cuda"}:
        raise ValueError(f"a sharded scan runs on CUDA shards or on CPU shards, got {kinds}")
    for x in xs3:
        if not x.is_contiguous():
            raise ValueError("ds scan kernel takes a contiguous tensor")
        if x.shape[0] > MAX_FRAMES:
            raise ValueError(f"batched ds scan takes at most {MAX_FRAMES} frames, got "
                             f"{x.shape[0]}")
    if xs3[0].shape[2] < 1:
        raise ValueError("ds scan kernel takes at least one column, got 0")
    packs = _sharded_pack(xs3, TILE, _kernel_pass(_kernel_pass1),
                          _kernel_pass(_kernel_pass2), send or _plain_send)
    return [q[0] for q in packs] if single else packs
