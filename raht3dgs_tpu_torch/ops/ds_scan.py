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
scans a matrix or a stack whose rows lie in shards on one device or
several (``parallel/sp_span.py``'s sp axis): one launch a pass a device
over all its shards' tiles, by a plan cached per layout
(:func:`scan_plan`), with only halos, tile totals, returned rows and
leading rows moving between devices; every shard's pack is its rows of the
unsharded pack, bit for bit (the plain version's, of the plain pack).

Both the kernel and :func:`ds_cumsum_reference` keep ~48 mantissa bits
(error-free two-sum) and give exact results for integer-valued lanes whose
partial sums stay below 2^24 — under their own association, which differs
between the two, so float lanes agree to ~1e-12 relative, not bitwise.
"""

from __future__ import annotations

import bisect
import ctypes
import functools
import math
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
    lib.ds_shard_pass_f32.argtypes = [i32, vp, vp, i32, ll, ll, ll, i32, ll, vp, ll, vp]
    lib.ds_shard_pass_f32.restype = i32


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
# Shard j holds rows [a_j, a_j + n_j) of an N-row matrix; several shards may
# lie on one device. Tile t (``tile`` rows: the kernel's TILE, the plain
# version's PLAIN_BLOCK) is owned by the shard that holds its first row; its
# rows past that shard (the halo, fewer than ``tile``) are the first rows of
# the shards after it. The unit of work is the device: each runs pass 1 (its
# shards' owned tiles' totals, written at their global index into one
# totals buffer) and pass 2 (those tiles scanned with the carries of the
# whole scan, every row written into the pack of the shard that holds it,
# and the leading row of each shard whose row before lies in one of them)
# once per call, over all its shards. Between devices only received halos,
# totals, returned rows and leading rows move (:func:`scan_plan`); between
# co-resident shards nothing does. Both versions give, on every shard, the
# bits of the unsharded call on the whole.


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


class Segment(NamedTuple):
    """Rows [start, start + rows) of the whole as one device holds them:
    its own shard's rows, or (``received``) the first rows of another
    device's shard that one of its tiles runs into, read from and written to
    buffers of their own."""
    shard: int
    start: int
    rows: int
    received: bool
    tile0: int      # tiles [tile0, tile0 + tiles) of the whole that the shard owns
    tiles: int
    local0: int     # the device's index of the first of them
    writes_lead: bool  # the device writes the shard's leading pack row in pass 2
    in_fs: int      # floats between frames of the segment's input and of its pack rows
    out_fs: int


class DeviceGroup(NamedTuple):
    """One device's part of a sharded scan: its shards, its segments in row
    order, the tiles it owns (each pass's blocks), the totals of other
    devices' tiles it receives, as (group, t0, t1) ranges, and its one
    allocation: each shard's pack, each received segment's input and pack
    rows, then the scratch (16-byte aligned offsets, in floats)."""
    shards: Tuple[int, ...]
    segments: Tuple[Segment, ...]
    tiles: int
    totals_in: Tuple[Tuple[int, int, int], ...]
    pack_at: Tuple[int, ...]        # per shard of ``shards``
    seg_in_at: Tuple[int, ...]      # per segment (received ones; -1 otherwise)
    seg_out_at: Tuple[int, ...]
    scratch_at: int
    floats: int
    table: object                   # the kernel's segment table, 8 int64 a segment


class Crossing(NamedTuple):
    """A piece counted as crossing from shard ``src`` to shard ``dst``:
    "halo" (src's first ``size`` rows), "totals" (the totals of src's
    ``size`` owned tiles), "back" (dst's first ``size`` rows scanned in
    src's tile) or "lead" (dst's leading row, src's last pack row)."""
    kind: str
    src: int
    dst: int
    size: int


class ScanPlan(NamedTuple):
    """A sharded scan's plan (:func:`scan_plan`)."""
    shards: Tuple[ShardPlan, ...]
    n: int
    T: int
    frames: int
    k: int
    scratch: int                      # floats of scratch a frame on each device
    group_of: Tuple[int, ...]         # each shard's device group
    groups: Tuple[DeviceGroup, ...]
    lead_copies: Tuple[int, ...]      # shards whose leading row is copied, in order
    crossings: Tuple[Crossing, ...]
    sent_bytes: int


def _up4(n: int) -> int:
    return -(-n // 4) * 4


@functools.lru_cache(maxsize=256)
def scan_plan(sizes: Tuple[int, ...], keys: Tuple, tile: int, frames: int, k: int,
              scratch: int) -> ScanPlan:
    """The plan of a sharded scan of ``frames`` frames of ``k`` columns
    over shards of ``sizes`` rows whose devices have the keys ``keys``
    (equal keys: one device), with ``scratch`` floats a frame of scratch
    on each device that owns a tile: which device scans which tile, the
    segments of rows each reads and writes, the totals and rows that move
    between devices, which leading rows are copied, what is counted as
    crossing between shards and its bytes. A pure function, cached."""
    plans = shard_plan(sizes, tile)
    N = sum(sizes)
    T = -(-N // tile)
    S = len(sizes)
    index, group_of = {}, []
    for key in keys:
        group_of.append(index.setdefault(key, len(index)))
    owners = [j for j, p in enumerate(plans) if p.tiles]
    starts = [plans[j].tile0 for j in owners]

    def owner(t: int) -> int:
        return owners[bisect.bisect_right(starts, t) - 1]

    # a shard's leading row is pass 2's where the tile of its row before
    # (tile 0 for the first rows: the zero row) is scanned on its device
    lead = [N > 0 and group_of[owner(max(p.start - 1, 0) // tile)] == group_of[j]
            for j, p in enumerate(plans)]
    groups = []
    for gi in range(len(index)):
        mine = tuple(j for j in range(S) if group_of[j] == gi)
        segs = [(plans[j].start, plans[j].rows, j, False) for j in mine]
        for j in mine:
            need, q = plans[j].halo, j + 1
            while need:
                take = min(need, plans[q].rows)
                if take and group_of[q] != gi:
                    segs.append((plans[q].start, take, q, True))
                need, q = need - take, q + 1
        segs.sort(key=lambda s: (s[0], s[1] > 0, s[2]))
        segments, local = [], 0
        for start, rows, j, received in segs:
            p = plans[j]
            tiles = 0 if received else p.tiles
            segments.append(Segment(j, start, rows, received, p.tile0 if tiles else 0, tiles,
                                    local, lead[j] and not received,
                                    rows * k if received else p.rows * k,
                                    rows * 2 * k if received else (p.rows + 1) * 2 * k))
            local += tiles
        totals_in = []
        if T > 1 and local:
            for j in owners:
                e, p = group_of[j], plans[j]
                if e == gi:
                    continue
                if totals_in and totals_in[-1][0] == e and totals_in[-1][2] == p.tile0:
                    totals_in[-1] = (e, totals_in[-1][1], p.tile0 + p.tiles)
                else:
                    totals_in.append((e, p.tile0, p.tile0 + p.tiles))
        at = 0
        pack_at = []
        for j in mine:
            pack_at.append(at)
            at += _up4(frames * (plans[j].rows + 1) * 2 * k)
        seg_in_at, seg_out_at = [], []
        for s in segments:
            if s.received:
                seg_in_at.append(at)
                at += _up4(frames * s.rows * k)
                seg_out_at.append(at)
                at += _up4(frames * s.rows * 2 * k)
            else:
                seg_in_at.append(-1)
                seg_out_at.append(-1)
        scratch_at = at
        at += frames * scratch if local else 0
        table = [v for s in segments for v in (s.start, s.rows, s.in_fs, s.out_fs, s.tile0,
                                                s.tiles, s.local0, int(s.writes_lead))]
        groups.append(DeviceGroup(mine, tuple(segments), local, tuple(totals_in),
                                  tuple(pack_at), tuple(seg_in_at), tuple(seg_out_at),
                                  scratch_at, at, (ctypes.c_longlong * len(table))(*table)))

    crossings = []
    for j in owners:
        need, q = plans[j].halo, j + 1
        while need:
            take = min(need, plans[q].rows)
            if take:
                crossings.append(Crossing("halo", q, j, take))
                crossings.append(Crossing("back", j, q, take))
            need, q = need - take, q + 1
    if T > 1:
        crossings += [Crossing("totals", q, j, plans[q].tiles)
                      for j in owners for q in owners if q != j]
    crossings += [Crossing("lead", j - 1, j, 1) for j in range(1, S)]
    per = {"halo": 1, "back": 2, "totals": 2, "lead": 2}
    sent = sum(4 * frames * k * per[c.kind] * c.size for c in crossings)
    return ScanPlan(tuple(plans), N, T, frames, k, scratch, tuple(group_of), tuple(groups),
                    tuple(j for j in range(S) if not lead[j]), tuple(crossings), sent)


class _Bufs(NamedTuple):
    """One device's tensors in a call: per segment its input, its pack rows
    (from the segment's first row) and its leading row (or None), and the
    (frames, scratch) scratch."""
    ins: list
    outs: list
    leads: list
    scratch: torch.Tensor


def _totals(plan: ScanPlan, scratch: torch.Tensor) -> torch.Tensor:
    """The (frames, 2, T, K) tile totals at the front of a device's scratch."""
    T, K = plan.T, plan.k
    return scratch[:, :2 * T * K].view(plan.frames, 2, T, K)


def _sharded_pack(xs, keys, tile: int, scratch: int, pass1, pass2, send) -> List[torch.Tensor]:
    """The bookkeeping of both versions of the sharded pack, by
    :func:`scan_plan`: ``xs`` are (B, n_j, K) float32, ``keys`` their
    devices' keys. ``pass1(plan, g, bufs)`` writes the totals of device
    group g's owned tiles into its scratch (and may return a state);
    ``pass2(plan, g, bufs, state)`` writes the pack rows of its tiles into
    the segments' outputs and the leading rows it owns. What moves between
    devices is copied here; ``send(t, device)``, if given, is called with
    every piece counted as crossing between shards."""
    B, K = xs[0].shape[0], xs[0].shape[2]
    sizes = tuple(x.shape[1] for x in xs)
    plan = scan_plan(sizes, tuple(keys), tile, B, K, scratch)
    packs: List[Optional[torch.Tensor]] = [None] * len(xs)
    bufs = []
    for g in plan.groups:
        x0 = xs[g.shards[0]]
        buf = x0.new_empty(g.floats)

        def view(at, *shape):
            return buf[at:at + math.prod(shape)].view(*shape)

        for j, at in zip(g.shards, g.pack_at):
            packs[j] = view(at, B, sizes[j] + 1, 2 * K)
        ins, outs, leads = [], [], []
        for s, i_at, o_at in zip(g.segments, g.seg_in_at, g.seg_out_at):
            if s.received:
                ins.append(view(i_at, B, s.rows, K))
                outs.append(view(o_at, B, s.rows, 2 * K))
                leads.append(None)
            else:
                ins.append(xs[s.shard])
                outs.append(packs[s.shard][:, 1:])
                leads.append(packs[s.shard][:, 0] if s.writes_lead else None)
        bufs.append(_Bufs(ins, outs, leads, view(g.scratch_at, B, scratch if g.tiles else 0)))
    # rows that a device's tiles run into, from the shards' devices
    for g, b in zip(plan.groups, bufs):
        for s, t in zip(g.segments, b.ins):
            if s.received:
                t.copy_(xs[s.shard][:, :s.rows])
    states = [pass1(plan, g, b) if g.tiles else None for g, b in zip(plan.groups, bufs)]
    # every device's missing totals, one copy a contiguous range of tiles
    for g, b in zip(plan.groups, bufs):
        for e, t0, t1 in g.totals_in:
            _totals(plan, b.scratch)[:, :, t0:t1].copy_(
                _totals(plan, bufs[e].scratch)[:, :, t0:t1])
    for g, b, st in zip(plan.groups, bufs, states):
        if g.tiles:
            pass2(plan, g, b, st)
    # scanned rows back to the shards that hold them, then the leading rows
    # that no pass 2 wrote, in shard order (an empty shard's is its only row)
    for g, b in zip(plan.groups, bufs):
        for s, t in zip(g.segments, b.outs):
            if s.received:
                packs[s.shard][:, 1:1 + s.rows].copy_(t)
    for j in plan.lead_copies:
        if j == 0:
            packs[j][:, 0] = 0.0
        else:
            packs[j][:, 0].copy_(packs[j - 1][:, -1])
    if send is not None:
        for c in plan.crossings:
            if c.kind == "halo":
                t = xs[c.src][:, :c.size]
            elif c.kind == "back":
                t = packs[c.dst][:, 1:1 + c.size]
            elif c.kind == "totals":
                t0 = plan.shards[c.src].tile0
                t = _totals(plan, bufs[plan.group_of[c.src]].scratch)[:, :, t0:t0 + c.size]
            else:
                t = packs[c.src][:, -1]
            send(t, xs[c.dst].device)
    return packs


def _plain_rows(plan: ScanPlan, g: DeviceGroup, ins, s: Segment, tile: int):
    """Owner segment s's tiles' rows, (B, m, K), read through the
    segments that hold them, and their first row."""
    lo = s.tile0 * tile
    hi = min((s.tile0 + s.tiles) * tile, plan.n)
    parts = [x[:, max(lo, t.start) - t.start:min(hi, t.start + t.rows) - t.start]
             for t, x in zip(g.segments, ins)
             if t.rows and t.start < hi and t.start + t.rows > lo]
    return (parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)), lo


def _plain_pass1(plan: ScanPlan, g: DeviceGroup, b: _Bufs):
    B, K, T = plan.frames, plan.k, plan.T
    state = []
    for s in g.segments:
        if not s.tiles:
            continue
        grid, lo = _plain_rows(plan, g, b.ins, s, PLAIN_BLOCK)
        m = grid.shape[1]
        cols = grid.permute(1, 0, 2).reshape(m, B * K)
        oh, ol = _block_scans(cols, torch.zeros_like(cols), PLAIN_BLOCK, T > 1)
        if T > 1:
            tot = torch.stack([oh[:, -1], ol[:, -1]]).reshape(2, s.tiles, B, K)
            _totals(plan, b.scratch)[:, :, s.tile0:s.tile0 + s.tiles] = tot.permute(2, 0, 1, 3)
        state.append((s, oh, ol, m, lo))
    return state


def _plain_pass2(plan: ScanPlan, g: DeviceGroup, b: _Bufs, state):
    B, K, T = plan.frames, plan.k, plan.T
    if T > 1:
        tot = _totals(plan, b.scratch)
        th = tot[:, 0].permute(1, 0, 2).reshape(T, B * K)
        tl = tot[:, 1].permute(1, 0, 2).reshape(T, B * K)
        ch, cl = _block_carries(th, tl, PLAIN_BLOCK)    # once a device
    for s, oh, ol, m, lo in state:
        if T > 1:
            sl = slice(s.tile0, s.tile0 + s.tiles)
            oh, ol = _ds_add(ch[sl], cl[sl], oh, ol)
        rows = torch.cat([t.reshape(-1, B, K)[:m].permute(1, 0, 2) for t in (oh, ol)], dim=2)
        hi = lo + m
        for t, out, lead in zip(g.segments, b.outs, b.leads):
            a, e = max(lo, t.start), min(hi, t.start + t.rows)
            if a < e:
                out[:, a - t.start:e - t.start] = rows[:, a - lo:e - lo]
            if lead is not None:
                if t.start == 0 and s.tile0 == 0:
                    lead.zero_()
                elif lo <= t.start - 1 < hi:
                    lead.copy_(rows[:, t.start - 1 - lo])


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


def ds_prefix_pack_sharded_reference(xs: Sequence[torch.Tensor],
                                     send: Optional[Callable] = None,
                                     keys: Optional[Sequence] = None) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`ds_prefix_pack_sharded` on any
    device: the plain version's 256-row blocks owned, carried and moved as
    the kernel's tiles are, so each shard's pack is bitwise its rows of
    :func:`ds_prefix_pack_reference` (:func:`ds_prefix_pack_batched_reference`)
    on the whole. ``keys`` group the shards by device (default: their
    devices); distinct keys on one device run the moves between devices as
    copies there."""
    xs3, single = _as_stack(xs)
    keys = [x.device for x in xs3] if keys is None else list(keys)
    if len(keys) != len(xs3):
        raise ValueError(f"{len(keys)} device keys for {len(xs3)} shards")
    B, N, K = xs3[0].shape[0], sum(x.shape[1] for x in xs3), xs3[0].shape[2]
    T = -(-N // PLAIN_BLOCK)
    packs = _sharded_pack(xs3, keys, PLAIN_BLOCK, 2 * T * K if T > 1 else 0,
                          _plain_pass1, _plain_pass2, send)
    return [q[0] for q in packs] if single else packs


def _kernel_pass(which: int):
    """Pass ``which`` (1: totals, 2: scan) of the kernel's sharded entry on
    one device group: its shards' tiles in one launch (pass 2 of more than
    MAX_CARRY_TILES tiles first scans the totals), on its device's current
    stream with that device current."""
    def run(plan: ScanPlan, g: DeviceGroup, b: _Bufs, state=None):
        x = b.ins[0]
        if x.get_device() != torch.cuda.current_device():
            with torch.cuda.device(x.device):
                return run(plan, g, b, state)
        lib = KERNEL.load()
        n = len(g.segments)
        ptrs = []
        for i, o, lead in zip(b.ins, b.outs, b.leads):
            ptrs += [i.data_ptr(), o.data_ptr(), None if lead is None else lead.data_ptr()]
        stream = torch._C._cuda_getCurrentRawStream(x.get_device())
        rc = lib.ds_shard_pass_f32(which, g.table, (ctypes.c_void_p * (3 * n))(*ptrs), n,
                                   plan.n, plan.T, g.tiles, plan.k, plan.frames,
                                   b.scratch.data_ptr(), plan.scratch, stream)
        if rc != 0:
            raise RuntimeError(f"ds_shard_pass_f32 pass {which} launch failed (code {rc})")
        if which == 2:
            LAUNCHES["ds_cumsum_sharded"] += 1
    return run


def ds_prefix_pack_sharded(xs: Sequence[torch.Tensor],
                           send: Optional[Callable] = None) -> List[torch.Tensor]:
    """The prefix pack of a matrix (or a stack of frames) whose rows lie in
    shards: ``xs`` the shards in row order, each (n_j, K) or (B, n_j, K)
    float32 and contiguous, on one device or several (any order; a device
    may hold several shards). Returns each shard's (n_j + 1, 2K) or (B,
    n_j + 1, 2K) pack: the inclusive prefix at the row before its first
    (zeros for the first shard), then its rows ``[hi | lo]``, bitwise rows
    a_j .. a_j + n_j of :func:`ds_prefix_pack` (:func:`ds_prefix_pack_batched`)
    on the whole. ``send(t, device)``, if given, is called with every piece
    that crosses between two shards, whether or not they share a device,
    and the destination shard's device (its result is not used): for F
    frames of K columns over S shards, 4FK (3H + 2(O - 1)T + 2(S - 1))
    bytes, H the halo rows (in, and their [hi | lo] rows back), O the
    shards that own a tile and T the tiles (every owner takes the others'
    (hi, lo) totals; nothing for one tile), and each shard's leading row.
    Tiles are TILE rows on the card, PLAIN_BLOCK in the plain version.

    CUDA shards run the kernel's sharded entry: per device, one launch of
    pass 1 and one of pass 2 over all its shards' tiles (counted as one
    launch), on that device's current stream, for at most 32 segments a
    device (its shards and the halos it receives); between devices, one
    copy per received halo, contiguous range of totals, returned halo and
    leading row, each stream-ordered by PyTorch's copy between devices.
    CPU shards run the plain version. A mix of the two raises."""
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
    B, K = xs3[0].shape[0], xs3[0].shape[2]
    if K < 1:
        raise ValueError("ds scan kernel takes at least one column, got 0")
    N = sum(x.shape[1] for x in xs3)
    packs = _sharded_pack(xs3, [x.device for x in xs3], TILE, scratch_floats(N, K),
                          _kernel_pass(1), _kernel_pass(2), send)
    return [q[0] for q in packs] if single else packs
