"""Batched frames, on one device or over a (dp, sp, tp) device mesh.

Counterpart of ``raht3dgs_tpu/parallel/sharding.py``. Each function there
``jax.vmap``s the per-frame codec over a (B, N, ...) stack of frames that
share one bucketed size; here the frame axis is written out
(``ops/raht_span.py``'s batched forms, ``ops/reorder.py:
coefficient_order_batched``), and the float32 prefix sums of the whole
stack run through the scan kernel's batched entry, one launch per pass.
Zero-weight padding is invisible to the transform and sorts last in the
stream order, and every frame keeps its own real count ``nvox``. Each
frame's result equals the single-frame codec's (``models/pipeline.py``)
on that frame, bit for bit.

The mesh is single-controller, as the JAX package's is: one process holds
a (dp, sp, tp) array of devices (:class:`Mesh`, :func:`make_mesh`) and
:func:`shard_batch` places a stack on it, frames over dp, points over sp,
channels over tp (:class:`Sharded`). Given sharded values, every batched
function runs on each (dp, tp) group's frames and channels, with the
group's devices current, and assembles the result on the mesh's first
device in the unsharded layout (the output reshards the JAX docstring
allows). CUDA launches are asynchronous, so the one host thread keeps
several cards busy. dp and tp move nothing else: a tp group transforms its
channel slice with its own weight column and structure pass, and the
scan's columns are independent, so each column is bitwise the unsharded
program's (the JAX package's ``shard_map`` stance).

sp shards the points themselves, for frames too large for one device:
with sp > 1 no function brings a group's point shards together. The
transform, the stream order and the inverse run shard by shard through the
point-sharded span codec (``parallel/sp_span.py``, over the scan kernel's
sharded entry), and between its phases only halos, tile totals, carries,
boundary tables, key histograms and the chain's crossing nodes cross
between the shards (``COUNTS["sp_exchange_bytes"]``; ``sp_span`` says what
and how many bytes). Each shard's coefficients and symbols go straight to
their stream positions in the output. A replicated argument (a plain
tensor) is on every device by definition; an argument indexed by stream
position and split over sp (an order, the symbols) is read by position
across the shards, counted. Every output is bitwise the unsharded call's,
float64 prefix sums on the card excepted (``sp_span``).
:func:`batched_roundtrip_step` sums each group's squared errors per frame
and channel in fixed blocks and adds them up on the first device (the
psum), in one association with and without a mesh.

A mesh may name one device many times: ``devices=[torch.device("cpu")] *
8`` is the tests' virtual mesh, ``[torch.device("cuda", 0)] * n`` a
virtual mesh on one card.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from raht3dgs_tpu_torch.models.pipeline import _quant_T_device
from raht3dgs_tpu_torch.ops.quantize import dequantize, dequantize_biased, quantize
from raht3dgs_tpu_torch.ops.raht_span import (
    _rows_batched,
    raht_forward_span_batched,
    raht_inverse_span_batched,
    raht_structure_span_batched,
)
from raht3dgs_tpu_torch.ops.reorder import coefficient_order_batched
from raht3dgs_tpu_torch.parallel import sp_span
from raht3dgs_tpu_torch.utils.device import DeviceLike, resolve_device

AXES = ("dp", "sp", "tp")

# Group runs of the batched functions on a mesh; the bytes that cross
# between sp shards (counted logically: on a virtual mesh too); and the
# bytes of point shards gathered onto one device, which no function does
# (it stays 0). Callers reset and read them.
COUNTS = {"groups": 0, "sp_exchange_bytes": 0, "sp_gather_bytes": 0}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


class Mesh:
    """A (dp, sp, tp) array of devices, the JAX package's ``Mesh`` for this
    package: ``devices`` a numpy object array of ``torch.device``,
    ``shape`` ``{"dp": .., "sp": .., "tp": ..}``."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 3:
            raise ValueError(f"a mesh is a (dp, sp, tp) array, got shape {devices.shape}")
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))

    @property
    def first(self) -> torch.device:
        """The device that gathered results land on."""
        return self.devices[0, 0, 0]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, at index 0 of the other axes."""
        idx = [0, 0, 0]
        idx[AXES.index(axis)] = slice(None)
        return list(self.devices[tuple(idx)])


def local_devices(device: DeviceLike = None) -> List[torch.device]:
    """The visible CUDA cards in index order, or ``[cpu]`` for
    ``device="cpu"``; raises without a card unless the CPU is asked for."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None, sp: int = 1, *,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (dp, sp, tp) mesh over ``devices`` (every visible CUDA card
    by default).

    Axes: ``dp`` shards the frame batch, ``sp`` the point dimension, ``tp``
    the attribute channels. Defaults: all devices on dp. ``dp * sp * tp``
    must equal the device count used. ``devices`` may repeat an entry (a
    virtual mesh)."""
    devs = list(local_devices() if devices is None else devices)
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(
            f"make_mesh needs {n} devices but {len(devs)} are given. For a virtual "
            f"mesh, pass devices= with repeated entries (devices=[torch.device('cuda', "
            f"0)] * {n} on one card, [torch.device('cpu')] * {n} on the CPU).")
    if dp is None and tp is None:
        dp, tp = n // sp, 1
    elif dp is None:
        dp = n // (tp * sp)
    elif tp is None:
        tp = n // (dp * sp)
    if dp * sp * tp != n:
        raise ValueError(f"dp*sp*tp = {dp}*{sp}*{tp} != n_devices {n}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devs[:n]):
        arr[i] = torch.device(d)
    return Mesh(arr.reshape(dp, sp, tp))


def _on(dev: torch.device):
    """``dev`` made the current device (nothing to do for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _split(mesh: Mesh, size: int, axis: str, c: int) -> slice:
    w = size // mesh.shape[axis]
    return slice(c * w, (c + 1) * w)


class Sharded:
    """A tensor placed on a mesh. ``spec`` names the mesh axis each
    dimension is split over (None: whole); ``blocks[(i, j, k)]`` is the
    block on ``mesh.devices[i, j, k]``, replicated over the axes the spec
    leaves out."""

    def __init__(self, mesh: Mesh, spec: tuple, shape: tuple, blocks: dict):
        self.mesh = mesh
        self.spec = spec
        self.shape = shape
        self.blocks = blocks

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[(0, 0, 0)].dtype

    def gather(self) -> torch.Tensor:
        """The whole tensor on the mesh's first device."""
        first = self.mesh.first
        out = torch.empty(self.shape, dtype=self.dtype, device=first)
        for idx, block in self.blocks.items():
            out[_block_slices(self.mesh, self.shape, self.spec, idx)] = block.to(first)
        return out


def _block_slices(mesh: Mesh, shape: tuple, spec: tuple, idx: tuple) -> tuple:
    return tuple(slice(None) if ax is None else _split(mesh, shape[d], ax, idx[AXES.index(ax)])
                 for d, ax in enumerate(spec))


def shard(mesh: Mesh, x, spec: tuple) -> Sharded:
    """Place ``x`` on ``mesh``: dimension d split over the mesh axis
    ``spec[d]`` (None or beyond the spec: whole). Raises ``ValueError`` when
    a split dimension does not divide by its axis size."""
    x = torch.as_tensor(x)
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    for d, ax in enumerate(spec):
        if ax is not None and x.shape[d] % mesh.shape[ax]:
            raise ValueError(
                f"dimension {d} of shape {tuple(x.shape)} does not divide by mesh axis "
                f"{ax!r} of size {mesh.shape[ax]}")
    blocks = {idx: x[_block_slices(mesh, x.shape, spec, idx)].to(mesh.devices[idx])
              .contiguous() for idx in np.ndindex(*mesh.devices.shape)}
    return Sharded(mesh, spec, tuple(x.shape), blocks)


def shard_batch(mesh: Mesh, codes, attrs, weights):
    """Place a frame batch on the mesh: batch over dp, points over sp,
    channels over tp (``P("dp", "sp")``, ``P("dp", "sp", "tp")``,
    ``P("dp", "sp")``)."""
    return (shard(mesh, codes, ("dp", "sp")), shard(mesh, attrs, ("dp", "sp", "tp")),
            shard(mesh, weights, ("dp", "sp")))


# -- running the single-device code on a mesh -----------------------------------

_F = ("dp",)                  # (B, ...): frames over dp
_FC = ("dp", None, "tp")      # (B, N, D)
_FCT = ("dp", "tp", None)     # (B, D, N)


class _Group(NamedTuple):
    i: int                    # dp index
    k: int                    # tp index
    dev: torch.device         # the group's sp-first device
    frames: slice
    chans: slice


def _mesh_of(*xs) -> Optional[Mesh]:
    return next((x.mesh for x in xs if isinstance(x, Sharded)), None)


def _channel_spec(v, D: int) -> tuple:
    """A (D,) per-channel vector rides the channel shards; anything else is
    replicated."""
    if isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim == 1 and v.shape[0] == D > 1:
        return ("tp",)
    return ()


def _local(x, spec, g: _Group, j: int = 0):
    """Argument ``x`` as group ``g``'s sp shard ``j`` sees it on its device:
    a sharded value's block there; a tensor sliced to the group's frames
    (``"dp"`` in ``spec``) and channels (``"tp"``). Other values pass as
    they are."""
    if spec is None or not isinstance(x, (Sharded, torch.Tensor, np.ndarray, list, tuple)):
        return x
    if isinstance(x, Sharded):
        dev = x.mesh.devices[g.i, j, g.k]
        t = x.blocks[(g.i, j, g.k)]
        have = x.spec
    else:
        dev = g.dev
        t = torch.as_tensor(x)
        have = (None,) * t.dim()
    sl = []
    for d in range(t.dim()):
        want = spec[d] if d < len(spec) else None
        if have[d] in ("dp", "tp") and have[d] != want:
            raise ValueError(f"an argument split over {have[d]!r} in dimension {d} where "
                             f"the function takes it {want or 'whole'}")
        sl.append({"dp": g.frames, "tp": g.chans}[want]
                  if want in ("dp", "tp") and have[d] != want else slice(None))
    return t[tuple(sl)].to(dev).contiguous()


def _sp_split(x, dim: int) -> bool:
    return isinstance(x, Sharded) and len(x.spec) > dim and x.spec[dim] == "sp"


def _point_shards(mesh: Mesh, x, spec, g: _Group) -> list:
    """A (B, N, ...) argument as group ``g``'s sp shards, each its (F,
    N / sp, ...) rows on its device: a value sharded over sp by points is
    its blocks, anything else is split there."""
    sp = mesh.shape["sp"]
    if isinstance(x, Sharded) and "sp" in x.spec and x.spec.index("sp") != 1:
        raise ValueError(f"an argument split over 'sp' in dimension {x.spec.index('sp')} "
                         "where the function takes points in dimension 1")
    out = []
    for j in range(sp):
        t = _local(x, spec, g, j)
        if not _sp_split(x, 1):
            if t.shape[1] % sp:
                raise ValueError(f"{t.shape[1]} points do not divide over sp={sp}")
            w = t.shape[1] // sp
            t = t[:, j * w:(j + 1) * w].to(mesh.devices[g.i, j, g.k]).contiguous()
        out.append(t)
    return out


def _assemble(mesh: Mesh, outs: dict, spec: tuple) -> torch.Tensor:
    """The groups' outputs in the unsharded layout on the first device."""
    first = mesh.first
    rows = []
    for i in range(mesh.shape["dp"]):
        if "tp" in spec and mesh.shape["tp"] > 1:
            row = torch.cat([outs[(i, k)].to(first) for k in range(mesh.shape["tp"])],
                            dim=spec.index("tp"))
        else:
            row = outs[(i, 0)].to(first)
        rows.append(row)
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=spec.index("dp"))


def _groups(mesh: Mesh, B: int, D: int, per_channel: bool):
    """The (dp, tp) groups of a call over ``B`` frames of ``D`` channels
    (only tp group 0 without a channel axis in the outputs)."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    if B % dp:
        raise ValueError(f"a batch of {B} frames does not divide over dp={dp}")
    if per_channel and D % tp:
        raise ValueError(f"{D} channels do not divide over tp={tp}")
    for i in range(dp):
        for k in range(tp if per_channel else 1):
            yield _Group(i, k, mesh.devices[i, 0, k], _split(mesh, B, "dp", i),
                         _split(mesh, D, "tp", k) if per_channel else slice(None))


def _map(mesh: Mesh, fn, args: tuple, specs: tuple, out_specs: tuple, B: int, D: int):
    """``fn`` on every (dp, tp) group's share of ``args`` (``specs`` their
    layouts, None for values that pass as they are), with the group's device
    current; the outputs (``out_specs`` their layouts) gathered onto the
    first device. Without a channel axis in the outputs only tp group 0
    runs. Functions of points take their sp route (:func:`_map_sp`) on a
    mesh with sp > 1."""
    per_channel = any("tp" in s for s in out_specs)
    outs = [{} for _ in out_specs]
    for g in _groups(mesh, B, D, per_channel):
        with _on(g.dev):
            res = fn(*[_local(a, s, g) for a, s in zip(args, specs)])
        COUNTS["groups"] += 1
        for o, r in zip(outs, res if isinstance(res, tuple) else (res,)):
            o[(g.i, g.k)] = r
    got = tuple(_assemble(mesh, o, s) for o, s in zip(outs, out_specs))
    return got if len(got) > 1 else got[0]


def _map_sp(mesh: Mesh, fn, B: int, D: int, out_specs: tuple):
    """``fn(g, devices)`` on every (dp, tp) group, ``devices`` its sp
    shards' in point order; each output (``out_specs`` their layouts, the
    groups' outputs already on the first device) assembled there."""
    per_channel = any("tp" in s for s in out_specs)
    outs = [{} for _ in out_specs]
    for g in _groups(mesh, B, D, per_channel):
        devs = [mesh.devices[g.i, j, g.k] for j in range(mesh.shape["sp"])]
        with _on(g.dev):
            res = fn(g, devs)
        COUNTS["groups"] += 1
        for o, r in zip(outs, res if isinstance(res, tuple) else (res,)):
            o[(g.i, g.k)] = r
    got = tuple(_assemble(mesh, o, s) for o, s in zip(outs, out_specs))
    return got if len(got) > 1 else got[0]


def _sp_mesh(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.shape["sp"] > 1


def _on_shards(mesh: Mesh, x, spec, g: _Group) -> list:
    """A frame- or channel-level argument (nvox, steps, qf) on each of
    group ``g``'s sp shards (anything but a tensor as it is)."""
    sp = mesh.shape["sp"]
    if isinstance(x, Sharded):
        return [_local(x, spec, g, j) for j in range(sp)]
    if not isinstance(x, (torch.Tensor, np.ndarray)):
        return [x] * sp
    t = _local(x, spec, g)
    return [t.to(mesh.devices[g.i, j, g.k]) for j in range(sp)]


def _sp_group(devs, shards: list) -> sp_span.SpGroup:
    return sp_span.SpGroup(devs, [x.shape[1] for x in shards], COUNTS)


def _positions(grp: sp_span.SpGroup, mesh: Mesh, order, g: _Group, first) -> torch.Tensor:
    """The (F, N) rows -> stream positions inverse of an ``order`` argument
    (stream position -> row), on ``first``: a value split over sp by
    position sends its blocks there (counted)."""
    if _sp_split(order, 1):
        blocks = [_local(order, _F, g, j) for j in range(mesh.shape["sp"])]
        order = torch.cat([b.to(first) if j == 0 else grp.send(b, first)
                           for j, b in enumerate(blocks)], dim=1)
    else:
        order = _local(order, _F, g).to(first)
    order = order.long()
    inv = torch.empty_like(order)
    return inv.scatter_(1, order, torch.arange(order.shape[1], device=first).expand_as(order))


def _scatter_columns(grp: sp_span.SpGroup, cols: list, pos: list, first) -> torch.Tensor:
    """Each shard's (F, C, n_j) columns placed at their (F, n_j) stream
    positions of the (F, C, N) output on ``first``."""
    F, C, _ = cols[0].shape
    out = cols[0].new_empty((F, C, grp.n), device=first)
    for c, p in zip(cols, pos):
        p = p.to(first).long()
        out.scatter_(2, p[:, None, :].expand(F, C, p.shape[1]), c.to(first))
    return out


def _order_from_positions(grp: sp_span.SpGroup, pos: list, first) -> torch.Tensor:
    """The (F, N) int32 stream order (position -> row) from the shards'
    positions, on ``first``."""
    F = pos[0].shape[0]
    out = torch.empty((F, grp.n), dtype=torch.int32, device=first)
    for j, p in enumerate(pos):
        rows = grp.rows(j, first).to(torch.int32).expand(F, -1)
        out.scatter_(1, p.to(first).long(), rows)
    return out


def _quant_rows(coeffs, steps, quant_mode, qf):
    """:func:`batched_quant_T` of (F, n, D) rows, (F, D, n) int32."""
    return _quant_T_device(coeffs.transpose(1, 2), steps, quant_mode, qf)


# -- the batched functions -------------------------------------------------------


def _nvox(nvox, codes: torch.Tensor) -> torch.Tensor:
    if nvox is None:
        return torch.full((codes.shape[0],), codes.shape[1], dtype=torch.int32,
                          device=codes.device)
    return torch.as_tensor(nvox, device=codes.device)


def _pads_last_batched(order: torch.Tensor, nvox: torch.Tensor) -> torch.Tensor:
    """``pipeline._pads_last`` of every frame: padding slots (>= that
    frame's nvox) last, the real relative order kept."""
    pads = (order >= nvox[:, None]).to(torch.int8)
    return torch.gather(order, 1, torch.argsort(pads, dim=1, stable=True))


def batched_forward(codes, attrs, weights, depth, order_mode="ragft", nvox=None):
    """Forward RAHT + pads-last coefficient order per frame (no quant).

    codes (B, N) | attrs (B, N, D) | weights (B, N) | nvox (B,) real voxel
    counts; tensors, or the :func:`shard_batch` values. Returns (coeffs
    (B, N, D), order (B, N) int32) — the step-independent half of the
    encode, reusable across a step sweep. ``weight_desc`` takes its order
    from the structure pass the decoder runs, as the single-frame codec
    does."""
    mesh = _mesh_of(codes, attrs, weights)
    if _sp_mesh(mesh):
        def group(g, devs):
            grp, T, pos = _sp_forward(mesh, g, devs, codes, attrs, weights, depth, order_mode,
                                      nvox)
            first = mesh.first
            return (torch.cat([t.to(first) for t in T], dim=1),
                    _order_from_positions(grp, pos, first))
        return _map_sp(mesh, group, attrs.shape[0], attrs.shape[2], (_FC, _F))
    if mesh is not None:
        return _map(mesh, batched_forward, (codes, attrs, weights, depth, order_mode, nvox),
                    (_F, _FC, _F, None, None, _F), (_FC, _F), attrs.shape[0], attrs.shape[2])
    res = raht_forward_span_batched(codes, attrs, weights, depth)
    structure = res.structure
    if order_mode == "weight_desc":
        structure = raht_structure_span_batched(codes, weights, depth)
    order = coefficient_order_batched(structure, order_mode)
    return res.coeffs, _pads_last_batched(order, _nvox(nvox, codes)).to(torch.int32)


def _sp_nvox(mesh, nvox, shards, g):
    """Each shard's (F,) real voxel counts (the frame's N where not given)."""
    if nvox is None:
        n = sum(x.shape[1] for x in shards)
        return [torch.full((c.shape[0],), n, dtype=torch.int32, device=c.device)
                for c in shards]
    return _on_shards(mesh, torch.as_tensor(nvox), _F, g)


def _sp_forward(mesh, g, devs, codes, attrs, weights, depth, order_mode, nvox):
    """One group's sharded forward: (its SpGroup, each shard's
    coefficients, each shard's stream positions)."""
    cs = _point_shards(mesh, codes, _F, g)
    as_ = _point_shards(mesh, attrs, _FC, g)
    ws = _point_shards(mesh, weights, _F, g)
    grp = _sp_group(devs, cs)
    res = sp_span.forward(grp, cs, as_, ws, depth)
    structs = [r[1] for r in res]
    if order_mode == "weight_desc":
        structs = sp_span.structure(grp, cs, ws, depth)
    pos = sp_span.stream_positions(grp, structs, _sp_nvox(mesh, nvox, cs, g), order_mode,
                                   depth)
    return grp, [r[0] for r in res], pos


def batched_reorder_T(coeffs, orderp):
    """The per-frame reorder gather + channel-major transpose:
    (B, N, D) -> (B, D, N). Quantization is elementwise and commutes with
    the permutation bitwise, so a sweep reorders once for all its steps."""
    mesh = _mesh_of(coeffs, orderp)
    if _sp_mesh(mesh):
        return _reorder_sp(mesh, coeffs, orderp, lambda g, j, rows: rows.transpose(1, 2))
    if mesh is not None:
        return _map(mesh, batched_reorder_T, (coeffs, orderp), (_FC, _F), (_FCT,),
                    coeffs.shape[0], coeffs.shape[2])
    return _rows_batched(coeffs, orderp).transpose(1, 2).contiguous()


def _reorder_sp(mesh, coeffs, orderp, columns):
    """Each sp shard's coefficient rows, made (F, C, n) columns on the
    shard by ``columns(g, j, rows)``, placed at their stream positions in
    the (B, C, N) output: the positions come from ``orderp`` on the first
    device."""
    def group(g, devs):
        rows = _point_shards(mesh, coeffs, _FC, g)
        grp = _sp_group(devs, rows)
        first = mesh.first
        inv = _positions(grp, mesh, orderp, g, first)
        pos = [inv[:, a:a + n] for a, n in zip(grp.starts, grp.sizes)]
        return _scatter_columns(grp, grp.each(lambda j, r: columns(g, j, r), rows), pos, first)
    return _map_sp(mesh, group, coeffs.shape[0], coeffs.shape[2], (_FCT,))


def batched_quant_T(coeffs_T, steps, quant_mode="mid", qf=0.0):
    """Quantize reordered (B, D, N) coefficients to int32 symbols; ``steps``
    a (1,) or per-channel (D,) tensor on the coefficients' device."""
    mesh = _mesh_of(coeffs_T)
    if mesh is not None and _sp_split(coeffs_T, 2) and mesh.shape["sp"] > 1:
        # elementwise: each sp block of positions on its own shard
        D = coeffs_T.shape[1]

        def group(g, devs):
            st = _on_shards(mesh, steps, _channel_spec(steps, D), g)
            qfs = _on_shards(mesh, qf, (), g)
            parts = [_quant_T_device(_local(coeffs_T, _FCT, g, j), st[j], quant_mode, qfs[j])
                     for j in range(len(devs))]
            return torch.cat([q.to(mesh.first) for q in parts], dim=2)
        return _map_sp(mesh, group, coeffs_T.shape[0], D, (_FCT,))
    if mesh is not None:
        D = coeffs_T.shape[1]
        return _map(mesh, batched_quant_T, (coeffs_T, steps, quant_mode, qf),
                    (_FCT, _channel_spec(steps, D), None, ()), (_FCT,), coeffs_T.shape[0], D)
    return _quant_T_device(coeffs_T, steps, quant_mode, qf)


def batched_quant_reorder(coeffs, steps, orderp, quant_mode="mid", qf=0.0):
    """Quantize + apply the per-frame pads-last order; (B, D, N) int32,
    each frame's channel a row whose ``[:nvox]`` prefix is its payload."""
    mesh = _mesh_of(coeffs, orderp)
    if _sp_mesh(mesh):
        D = coeffs.shape[2]
        # quantization commutes with the permutation: each shard quantizes
        # its rows, the symbols go to their positions
        return _reorder_sp(mesh, coeffs, orderp, lambda g, j, rows: _quant_rows(
            rows, _on_shards(mesh, steps, _channel_spec(steps, D), g)[j], quant_mode,
            _on_shards(mesh, qf, (), g)[j]))
    if mesh is not None:
        D = coeffs.shape[2]
        return _map(mesh, batched_quant_reorder, (coeffs, steps, orderp, quant_mode, qf),
                    (_FC, _channel_spec(steps, D), _F, None, ()), (_FCT,), coeffs.shape[0], D)
    return batched_quant_T(batched_reorder_T(coeffs, orderp), steps, quant_mode, qf)


def batched_transform_step(codes, attrs, weights, steps, depth, order_mode="ragft",
                           nvox=None):
    """:func:`batched_forward` + :func:`batched_quant_reorder` in one call
    (sweeps should use the split pair to reuse the transform)."""
    mesh = _mesh_of(codes, attrs, weights)
    if _sp_mesh(mesh):
        D = attrs.shape[2]

        def group(g, devs):
            grp, T, pos = _sp_forward(mesh, g, devs, codes, attrs, weights, depth, order_mode,
                                      nvox)
            st = _on_shards(mesh, steps, _channel_spec(steps, D), g)
            q = grp.each(lambda j, t: _quant_rows(t, st[j], "mid", 0.0), T)
            return _scatter_columns(grp, q, pos, mesh.first)
        return _map_sp(mesh, group, attrs.shape[0], D, (_FCT,))
    if mesh is not None:
        D = attrs.shape[2]
        return _map(mesh, batched_transform_step,
                    (codes, attrs, weights, steps, depth, order_mode, nvox),
                    (_F, _FC, _F, _channel_spec(steps, D), None, None, _F), (_FCT,),
                    attrs.shape[0], D)
    coeffs, orderp = batched_forward(codes, attrs, weights, depth, order_mode, nvox)
    return batched_quant_reorder(coeffs, steps, orderp)


def batched_transform_step_tp(mesh: Mesh, codes, attrs, weights, steps, depth,
                              order_mode="ragft", nvox=None):
    """Channel-parallel encode over (dp, tp): each group transforms its
    frames' channel slice (D/tp channels) with its own weight column and
    structure pass, with nothing crossing between groups, and the result
    equals :func:`batched_transform_step`'s, channel-major (B, D, N) int32.

    ``codes`` / ``attrs`` / ``weights`` are tensors or sharded values;
    ``steps`` a scalar, its ``(1,)`` form, or a (D,) per-channel vector
    (sharded over tp with the channels). Requires sp == 1."""
    if mesh.shape["sp"] != 1:
        raise ValueError(
            "batched_transform_step_tp shards channels, not points; use the "
            "GSPMD batched_transform_step for sp > 1"
        )
    B, D = attrs.shape[0], attrs.shape[2]
    steps = torch.as_tensor(steps)
    if steps.dim() == 0 or (steps.dim() == 1 and steps.shape[0] == 1):
        steps, step_spec = steps.reshape(1), ()
    elif steps.dim() == 1 and steps.shape[0] == D:
        step_spec = ("tp",)
    else:
        raise ValueError(
            f"steps must be a scalar or a ({D},) per-channel "
            f"vector, got shape {tuple(steps.shape)}"
        )
    return _map(mesh, batched_transform_step,
                (codes, attrs, weights, steps, depth, order_mode, nvox),
                (_F, _FC, _F, step_spec, None, None, _F), (_FCT,), B, D)


def batched_inverse_order(codes, weights, nvox, depth, order_mode="ragft"):
    """Per-frame inverse of the pads-last stream permutation (decoder side),
    int32 (B, N)."""
    mesh = _mesh_of(codes, weights)
    if _sp_mesh(mesh):
        def group(g, devs):
            cs = _point_shards(mesh, codes, _F, g)
            ws = _point_shards(mesh, weights, _F, g)
            grp = _sp_group(devs, cs)
            pos = sp_span.stream_positions(grp, sp_span.structure(grp, cs, ws, depth),
                                           _sp_nvox(mesh, nvox, cs, g), order_mode, depth)
            return torch.cat([p.to(mesh.first) for p in pos], dim=1).to(torch.int32)
        return _map_sp(mesh, group, codes.shape[0], 1, (_F,))
    if mesh is not None:
        return _map(mesh, batched_inverse_order, (codes, weights, nvox, depth, order_mode),
                    (_F, _F, _F, None, None), (_F,), codes.shape[0], 1)
    structure = raht_structure_span_batched(codes, weights, depth)
    order2 = _pads_last_batched(coefficient_order_batched(structure, order_mode),
                                _nvox(nvox, codes))
    return torch.argsort(order2, dim=1, stable=True).to(torch.int32)


def batched_decode_step(codes, weights, qfull, inv, steps, depth,
                        dtype=torch.float64, quant_mode="mid", delta=0.0):
    """Dequantize + inverse RAHT for a batch of frames: ``qfull`` (B, D, N)
    stream-order symbols (pads last), ``inv`` (B, N) from
    :func:`batched_inverse_order`. Returns (B, N, D)."""
    mesh = _mesh_of(codes, weights, qfull, inv)
    if _sp_mesh(mesh):
        D = qfull.shape[1]

        def group(g, devs):
            cs = _point_shards(mesh, codes, _F, g)
            ws = _point_shards(mesh, weights, _F, g)
            grp = _sp_group(devs, cs)
            pos = _point_shards(mesh, inv, _F, g)
            q = _symbols_at(mesh, grp, qfull, pos, g)
            st = _on_shards(mesh, steps, _channel_spec(steps, D), g)
            dl = _on_shards(mesh, delta, (), g)
            coeffs = grp.each(lambda j, r: (dequantize_biased(r, st[j], dl[j], dtype=dtype)
                                            if quant_mode == "deadzone"
                                            else dequantize(r, st[j], dtype=dtype)), q)
            rec = sp_span.inverse(grp, coeffs, cs, ws, depth)
            return torch.cat([r.to(mesh.first) for r in rec], dim=1)
        return _map_sp(mesh, group, codes.shape[0], D, (_FC,))
    if mesh is not None:
        D = qfull.shape[1]
        return _map(mesh, batched_decode_step,
                    (codes, weights, qfull, inv, steps, depth, dtype, quant_mode, delta),
                    (_F, _F, _FCT, _F, _channel_spec(steps, D), None, None, None, ()),
                    (_FC,), codes.shape[0], D)
    q = _rows_batched(qfull.transpose(1, 2), inv)
    if quant_mode == "deadzone":
        coeffs = dequantize_biased(q, steps, delta, dtype=dtype)
    else:
        coeffs = dequantize(q, steps, dtype=dtype)
    return raht_inverse_span_batched(coeffs, codes, weights, depth)


def _symbols_at(mesh, grp: sp_span.SpGroup, qfull, pos: list, g: _Group) -> list:
    """Each shard's (F, n_j, D) symbols at its rows' stream positions
    ``pos``: read on the shard from a replicated ``qfull``; from one split
    over sp by position, each shard's positions go to every other shard and
    the symbols found there come back (counted)."""
    if not _sp_split(qfull, 2):
        Q = _on_shards(mesh, qfull, _FCT, g)
        return grp.each(lambda j, p: _rows_batched(Q[j].transpose(1, 2), p), pos)
    blocks = [_local(qfull, _FCT, g, j).transpose(1, 2) for j in range(grp.S)]
    width = blocks[0].shape[1]

    def fetch(j, p):
        dev = p.device
        got = None
        for k, blk in enumerate(blocks):
            lo = k * width
            asked = p if k == j else grp.send(p, blk.device)
            rows = _rows_batched(blk, (asked - lo).clamp(0, width - 1))
            rows = rows if k == j else grp.send(rows, dev)
            inside = ((p >= lo) & (p < lo + width))[..., None]
            got = rows if got is None else torch.where(inside, rows, got)
        return got

    return grp.each(fetch, pos)


def _squared_errors(attrs, weights, rec):
    """(F, n, D) squared reconstruction errors of the real voxels, and the
    real voxels' channel count per frame, (F, 1)."""
    valid = (weights > 0)[..., None]
    err = torch.where(valid, rec - attrs, torch.zeros((), dtype=attrs.dtype,
                                                      device=attrs.device))
    return err * err, valid.sum(dim=(1, 2))[:, None] * attrs.shape[2]


def _roundtrip_sums(codes, attrs, weights, steps, depth):
    """Squared reconstruction error per frame and channel, (B, D), and the
    real voxels' channel count per frame, (B, 1). Each channel sums alone
    in ``sp_span.block_sums`` / ``tree_sum``'s fixed association, so a
    channel slice, and the shards of the points, sum as the whole does."""
    res = raht_forward_span_batched(codes, attrs, weights, depth)
    rec = raht_inverse_span_batched(
        dequantize(quantize(res.coeffs, steps), steps, dtype=attrs.dtype),
        codes, weights, depth)
    sq, count = _squared_errors(attrs, weights, rec)
    return sp_span.tree_sum(sp_span.block_sums(sq)), count


def batched_roundtrip_step(codes, attrs, weights, steps, depth):
    """Forward, quantize, dequantize and inverse over a batch, and the mean
    squared reconstruction error over every real voxel's channels. On a
    mesh each group sums its own frames and channels, and the sums meet on
    the first device (the psum)."""
    mesh = _mesh_of(codes, attrs, weights)
    if _sp_mesh(mesh):
        D = attrs.shape[2]

        def group(g, devs):
            cs = _point_shards(mesh, codes, _F, g)
            as_ = _point_shards(mesh, attrs, _FC, g)
            ws = _point_shards(mesh, weights, _F, g)
            grp = _sp_group(devs, cs)
            st = _on_shards(mesh, steps, _channel_spec(steps, D), g)
            T = [r[0] for r in sp_span.forward(grp, cs, as_, ws, depth)]
            deq = grp.each(lambda j, t, a: dequantize(quantize(t, st[j]), st[j], dtype=a.dtype),
                           T, as_)
            rec = sp_span.inverse(grp, deq, cs, ws, depth)
            parts = grp.each(lambda j, a, w, r: _squared_errors(a, w, r), as_, ws, rec)
            sq = sp_span.squared_error_sums(grp, [p[0] for p in parts])
            count = sum(p[1].to(mesh.first) for p in parts)
            return sq.to(mesh.first), count
        sq, count = _map_sp(mesh, group, attrs.shape[0], D, (("dp", "tp"), ("dp", "tp")))
    elif mesh is not None:
        D = attrs.shape[2]
        sq, count = _map(mesh, _roundtrip_sums, (codes, attrs, weights, steps, depth),
                         (_F, _FC, _F, _channel_spec(steps, D), None),
                         (("dp", "tp"), ("dp", "tp")), attrs.shape[0], D)
    else:
        sq, count = _roundtrip_sums(codes, attrs, weights, steps, depth)
    return sq.sum() / torch.clamp_min(count.sum(), 1)
