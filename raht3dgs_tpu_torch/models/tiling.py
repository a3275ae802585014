"""Tile-partitioned frames (``.r3tt``): spatial random access (ROI decode).

Counterpart of ``raht3dgs_tpu/models/tiling.py``, the same container bytes.
A frame is partitioned into BRICKS, the octree cells at ``brick_depth``, and
each occupied brick encodes as its own standard ``FrameStream`` at the
frame's depth with the frame's ``vmin`` / ``width``: brick voxels share
their top Morton bits, so above the brick root the transform's butterflies
are identities and a brick's coefficients are those of a local transform.
A receiver decodes only the bricks that meet its region of interest.

Container, version 1::

    'R3TT' | u8 version=1 | u8 depth | u8 brick_depth | u8 flags(0) |
    u32 n_tiles | i64 keys[n_tiles] | u64 offsets[n_tiles + 1] |
    tile blobs (each a complete R3TC FrameStream)

Version 2 (the default writer) stores what the tiles share once: one
header template (a zero-voxel R3TC stream) and an optional global geometry
section; tiles shrink to bodies::

    'R3TT' | u8 version=2 | u8 depth | u8 brick_depth | u8 flags |
    u32 n_tiles | i64 keys[n_tiles] | u64 offsets[n_tiles + 1] |
    [flags bit0: u32 geom_len | global geometry section] |
    u32 tmpl_len | header template | tile bodies

    body: u32 n_voxels | [flags bit2: u32 predict_mask]
        | [flags bit1: ceil(D/8) entropy-map bytes]
        | u32 channel_len[D] | channel payloads

Flags: bit0 global geometry, bit1 per-tile entropy maps (bit c set =
channel c is RAC), bit2 per-tile predicted-RAHT masks.
``TiledReader.tile(i)`` rebuilds a standard :class:`FrameStream` either
way, so decoders are version-blind. ``keys`` are the occupied bricks'
Morton codes at ``brick_depth``, ascending: concatenating tiles in key
order gives the frame's global Morton order.

Each tile's frame is prepared, transformed and inverted on the codec's
device (CUDA unless ``device="cpu"``); the entropy coders and the
container run on the host.
"""

from __future__ import annotations

import struct
from dataclasses import replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from raht3dgs_tpu_torch.codec.bitstream import FrameStream
from raht3dgs_tpu_torch.codec.geometry import geometry_from_positions, positions_from_geometry
from raht3dgs_tpu_torch.ops.morton import morton_codes_np
from raht3dgs_tpu_torch.utils.device import DeviceLike, resolve_device

TILE_MAGIC = b"R3TT"
TILE_VERSION = 2
_TFLAG_GEOM = 1
_TFLAG_EMAP = 2
_TFLAG_PREDICT = 4


def brick_keys_np(codes: np.ndarray, depth: int, brick_depth: int) -> np.ndarray:
    """Brick Morton key (top ``3*brick_depth`` bits) of each voxel code."""
    shift = 3 * (depth - brick_depth)
    return (codes.astype(np.uint64) >> np.uint64(shift)).astype(np.int64)


def brick_boxes_np(keys, depth: int, brick_depth: int) -> Tuple[np.ndarray, int]:
    """Voxel-coordinate low corners ``(K, 3)`` of brick keys and the brick
    side: the keys' Morton digits decoded on the host (``brick_box`` of the
    JAX package decodes each key on the device)."""
    keys = np.asarray(keys, dtype=np.int64).reshape(-1)
    bxyz = np.zeros((len(keys), 3), dtype=np.int64)
    for b in range(brick_depth):
        bxyz[:, 2] |= ((keys >> (3 * b)) & 1) << b
        bxyz[:, 1] |= ((keys >> (3 * b + 1)) & 1) << b
        bxyz[:, 0] |= ((keys >> (3 * b + 2)) & 1) << b
    side = 1 << (depth - brick_depth)
    return bxyz * side, side


def brick_box(key: int, depth: int, brick_depth: int) -> Tuple[np.ndarray, np.ndarray]:
    """Voxel-coordinate bounding box [lo, hi) of a brick key."""
    los, side = brick_boxes_np([key], depth, brick_depth)
    return los[0], los[0] + side


def _emap_bytes(entropy_map, n_channels: int) -> bytes:
    bits = bytearray((n_channels + 7) // 8)
    if entropy_map is not None:
        for c, is_rac in enumerate(entropy_map):
            if is_rac:
                bits[c // 8] |= 1 << (c % 8)
    return bytes(bits)


def _pack_body(stream: FrameStream, flags: int) -> bytes:
    body = struct.pack("<I", stream.n_voxels)
    if flags & _TFLAG_PREDICT:
        body += struct.pack("<I", stream.predict_mask)
    if flags & _TFLAG_EMAP:
        body += _emap_bytes(stream.entropy_map, stream.n_channels)
    body += struct.pack(f"<{stream.n_channels}I", *[len(c) for c in stream.channels])
    return body + b"".join(stream.channels)


def _runs(keys: np.ndarray):
    """(start, end) of each run of equal keys."""
    starts = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
    ends = np.concatenate([starts[1:], [len(keys)]])
    return zip(starts, ends)


def positions_by_brick(positions: np.ndarray, depth: int, brick_depth: int) -> dict:
    """{brick key: that brick's rows of ``positions``, in Morton order}."""
    positions = np.asarray(positions)
    codes = morton_codes_np(positions.astype(np.int64), depth)
    order = np.argsort(codes, kind="stable")
    keys = brick_keys_np(codes[order], depth, brick_depth)
    return {int(keys[s]): positions[order[s:e]] for s, e in _runs(keys)}


def encode_tiled_frame(
    V: np.ndarray,
    attrs: np.ndarray,
    depth: int,
    brick_depth: int,
    codec,
    steps,
    *,
    bucket: int = 1 << 10,
    code_geometry: bool = False,
    vmin: Optional[np.ndarray] = None,
    width: Optional[float] = None,
    version: int = TILE_VERSION,
) -> Tuple[bytes, List[Tuple[int, int, int]]]:
    """Encode unique integer voxel positions + attributes as an ``.r3tt``
    tiled frame. Returns ``(blob, [(key, n_voxels, n_bytes), ...])``.

    ``codec`` is an :class:`AttributeCodec` at ``depth``; every tile runs
    on its device. ``vmin`` / ``width`` are the GLOBAL frame metadata,
    shared by every tile so that any subset reconstructs in frame
    coordinates. ``code_geometry`` makes the blob self-contained: a
    geometry section per tile at ``version=1``, one global section at
    ``version=2`` (decoders partition its positions by brick key)."""
    from raht3dgs_tpu_torch.models.pipeline import prepare_voxel_frame

    if not 0 < brick_depth < depth:
        raise ValueError(
            f"brick_depth must be in (0, depth): got {brick_depth} at depth {depth}"
        )
    if version not in (1, 2):
        raise ValueError(f"unsupported tiled-frame version {version}")
    V = np.asarray(V)
    attrs = np.asarray(attrs)
    codes = morton_codes_np(V.astype(np.int64), depth)
    order = np.argsort(codes, kind="stable")
    if len(np.unique(codes)) != len(codes):
        raise ValueError("tiled encode needs unique voxel positions")
    keys = brick_keys_np(codes[order], depth, brick_depth)
    streams, stats_ne = [], []
    for s, e in _runs(keys):
        idx = order[s:e]
        frame = prepare_voxel_frame(
            V[idx].astype(np.int64), attrs[idx], depth, bucket=bucket,
            dtype=codec.dtype, vmin=vmin, width=width, device=codec.device,
        )
        enc = codec.encode(frame, steps)
        if code_geometry and version == 1:
            enc.stream.geometry = geometry_from_positions(V[idx], depth)
        streams.append(enc.stream)
        stats_ne.append((int(keys[s]), int(e - s)))

    flags = 0
    tail = b""
    if version == 1:
        blobs = [st.to_bytes() for st in streams]
    else:
        if code_geometry:
            flags |= _TFLAG_GEOM
            geom = geometry_from_positions(V, depth)
            tail += struct.pack("<I", len(geom)) + geom
        if any(st.entropy_map is not None for st in streams):
            flags |= _TFLAG_EMAP
        if any(st.predict for st in streams):
            flags |= _TFLAG_PREDICT
        tmpl = replace(
            streams[0], n_voxels=0, channels=[b""] * streams[0].n_channels,
            entropy_map=None, predict_mask=0, geometry=None,
        ).to_bytes()
        tail += struct.pack("<I", len(tmpl)) + tmpl
        blobs = [_pack_body(st, flags) for st in streams]
    head_len = 12 + 8 * len(blobs) + 8 * (len(blobs) + 1) + len(tail)

    offsets = [head_len]
    for b in blobs:
        offsets.append(offsets[-1] + len(b))
    out = bytearray()
    out += struct.pack("<4sBBBBI", TILE_MAGIC, version, depth, brick_depth, flags,
                       len(blobs))
    out += struct.pack(f"<{len(blobs)}q", *[k for k, _ in stats_ne])
    out += struct.pack(f"<{len(blobs) + 1}Q", *offsets)
    out += tail
    for b in blobs:
        out += b
    stats = [(k, n, len(b)) for (k, n), b in zip(stats_ne, blobs)]
    return bytes(out), stats


class TiledReader:
    """Random-access reader over an ``.r3tt`` tiled frame (v1 or v2)."""

    def __init__(self, data: bytes):
        if len(data) < 12:
            raise ValueError("truncated tiled frame: header needs 12 bytes")
        magic, version, depth, brick_depth, flags, n = struct.unpack("<4sBBBBI", data[:12])
        if magic != TILE_MAGIC:
            raise ValueError(f"bad tiled-frame magic {magic!r}")
        if version not in (1, 2):
            raise ValueError(f"unsupported tiled-frame version {version}")
        if not 0 < brick_depth < depth:
            raise ValueError(
                f"corrupt tiled frame: brick_depth {brick_depth} at depth {depth}"
            )
        need = 12 + 8 * n + 8 * (n + 1)
        if len(data) < need:
            raise ValueError("truncated tiled frame: index cut off")
        self.version = version
        self.depth = depth
        self.brick_depth = brick_depth
        self._flags = flags
        self.keys = np.frombuffer(data[12:12 + 8 * n], dtype=np.int64)
        off0 = 12 + 8 * n
        self._offsets = struct.unpack(f"<{n + 1}Q", data[off0:off0 + 8 * (n + 1)])
        if any(self._offsets[i + 1] < self._offsets[i] for i in range(n)):
            raise ValueError("corrupt tiled frame: offsets not nondecreasing")
        if self._offsets[-1] > len(data):
            raise ValueError(
                f"truncated tiled frame: tiles need {self._offsets[-1]} "
                f"bytes, have {len(data)}"
            )
        if n and np.any(self.keys[1:] <= self.keys[:-1]):
            raise ValueError("corrupt tiled frame: keys not ascending")
        # geometry: the global geometry section (v2, flags bit 0);
        # template: the shared header (v2)
        self.geometry: Optional[bytes] = None
        self._template: Optional[FrameStream] = None
        pos = off0 + 8 * (n + 1)
        if version == 2:
            if flags & _TFLAG_GEOM:
                self.geometry, pos = self._section(data, pos, "geometry")
            tmpl, pos = self._section(data, pos, "header template")
            self._template = FrameStream.from_bytes(tmpl)
            if self._template.depth != depth:
                raise ValueError(
                    f"corrupt tiled frame: template depth {self._template.depth} "
                    f"!= container depth {depth}"
                )
            if pos != self._offsets[0]:
                raise ValueError(
                    f"corrupt tiled frame: first tile offset {self._offsets[0]} does "
                    f"not follow the header sections (ending at {pos})"
                )
        self._data = data

    @staticmethod
    def _section(data: bytes, pos: int, what: str) -> Tuple[bytes, int]:
        if len(data) < pos + 4:
            raise ValueError(f"truncated tiled frame: {what} length cut off")
        (length,) = struct.unpack("<I", data[pos:pos + 4])
        pos += 4
        if len(data) < pos + length:
            raise ValueError(f"truncated tiled frame: {what} cut off")
        return data[pos:pos + length], pos + length

    @property
    def meta(self) -> FrameStream:
        """A :class:`FrameStream` with the frame-global header fields (vmin,
        width, steps, quantizer, dtype): the shared template (v2) or tile 0
        (v1); every tile stores the same global fields."""
        return self._template if self._template is not None else self.tile(0)

    @property
    def fixed_bytes(self) -> int:
        """Bytes a receiver fetches whatever tiles it selects: header,
        key and offset tables, global geometry and header template."""
        return self._offsets[0]

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def n_voxels(self) -> int:
        return sum(self.tile(i).n_voxels for i in range(len(self)))

    def tile_bytes(self, i: int) -> bytes:
        if not 0 <= i < len(self):
            raise IndexError(f"tile {i} out of range [0, {len(self)})")
        return self._data[self._offsets[i]:self._offsets[i + 1]]

    def tile(self, i: int) -> FrameStream:
        """The tile's standard :class:`FrameStream` (version-blind)."""
        body = self.tile_bytes(i)
        if self.version == 1:
            return FrameStream.from_bytes(body)
        t = self._template
        D = t.n_channels
        if len(body) < 4:
            raise ValueError("truncated tile body")
        (nvox,) = struct.unpack("<I", body[:4])
        pos = 4
        predict_mask = 0
        if self._flags & _TFLAG_PREDICT:
            if len(body) < pos + 4:
                raise ValueError("truncated tile body: predict mask")
            (predict_mask,) = struct.unpack("<I", body[pos:pos + 4])
            pos += 4
        emap = None
        if self._flags & _TFLAG_EMAP:
            nb = (D + 7) // 8
            if len(body) < pos + nb:
                raise ValueError("truncated tile body: entropy map")
            bits = body[pos:pos + nb]
            pos += nb
            emap = tuple(bool(bits[c // 8] >> (c % 8) & 1) for c in range(D))
            if not any(emap):
                emap = None
        if len(body) < pos + 4 * D:
            raise ValueError("truncated tile body: channel lengths")
        lens = struct.unpack(f"<{D}I", body[pos:pos + 4 * D])
        pos += 4 * D
        if pos + sum(lens) != len(body):
            raise ValueError(
                f"corrupt tile body: channels need {sum(lens)} bytes, "
                f"body has {len(body) - pos}"
            )
        channels = []
        for ln in lens:
            channels.append(body[pos:pos + ln])
            pos += ln
        return replace(
            t, n_voxels=int(nvox), channels=channels, entropy_map=emap,
            predict=bool(self._flags & _TFLAG_PREDICT), predict_mask=int(predict_mask),
        )

    def select_roi(self, lo, hi) -> List[int]:
        """Tile indices whose brick boxes meet the voxel-coordinate box
        [lo, hi) (half-open, per axis)."""
        lo = np.asarray(lo, dtype=np.int64)
        hi = np.asarray(hi, dtype=np.int64)
        if lo.shape != (3,) or hi.shape != (3,):
            raise ValueError("roi lo/hi must be 3-vectors")
        if np.any(hi <= lo):
            raise ValueError(f"empty ROI: lo {lo.tolist()} hi {hi.tolist()}")
        blo, side = brick_boxes_np(self.keys, self.depth, self.brick_depth)
        meet = np.all(blo < hi, axis=1) & np.all(blo + side > lo, axis=1)
        return np.flatnonzero(meet).tolist()


def decode_tiled_frame(
    data,
    *,
    roi: Optional[Tuple] = None,
    positions: Optional[np.ndarray] = None,
    codec=None,
    dtype=None,
    bucket: int = 1 << 10,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode an ``.r3tt`` frame (or only the tiles meeting ``roi = (lo,
    hi)``). Returns ``(positions, attributes)`` in global Morton order; with
    ``roi`` the result is clipped to exactly the box.

    Tiles written with ``code_geometry=True`` are self-contained; otherwise
    ``positions`` (the frame's unique integer voxels) supplies the geometry
    and is partitioned by brick here. Runs on ``codec``'s device when one
    is given, else on CUDA unless ``device="cpu"``."""
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec, prepare_voxel_frame

    dev = codec.device if codec is not None else resolve_device(device)
    reader = data if isinstance(data, TiledReader) else TiledReader(data)
    sel = reader.select_roi(*roi) if roi is not None else list(range(len(reader)))
    if not sel:
        raise ValueError("ROI intersects no occupied brick")
    pos_parts, attr_parts = [], []
    by_brick = None
    if positions is None and reader.geometry is not None:
        # the v2 global geometry section: the frame's positions once,
        # partitioned by brick key below
        positions = positions_from_geometry(reader.geometry, reader.depth,
                                            reader.n_voxels, device=dev)
    if positions is not None:
        by_brick = positions_by_brick(positions, reader.depth, reader.brick_depth)
    for i in sel:
        stream = reader.tile(i)
        if dtype is None:
            dtype = torch.float32 if stream.dtype32 else torch.float64
        if codec is None:
            codec = AttributeCodec(reader.depth, dtype=dtype, order_mode=stream.order_mode,
                                   device=dev)
        if stream.geometry is not None:
            Vt = positions_from_geometry(stream.geometry, reader.depth, stream.n_voxels,
                                         device=dev)
        elif by_brick is not None:
            Vt = by_brick.get(int(reader.keys[i]))
            if Vt is None or len(Vt) != stream.n_voxels:
                raise ValueError(
                    f"positions do not cover brick {int(reader.keys[i])} "
                    f"({0 if Vt is None else len(Vt)} voxels vs "
                    f"{stream.n_voxels} in the stream)"
                )
        else:
            raise ValueError(
                "tiles carry no geometry sections — pass positions= (or "
                "re-encode with code_geometry=True)"
            )
        Vt = np.asarray(Vt)
        Vi = Vt.astype(np.int64)
        frame = prepare_voxel_frame(Vi, np.zeros((len(Vt), stream.n_channels)),
                                    reader.depth, bucket=bucket, dtype=dtype, device=dev)
        rec, _ = codec.decode(stream, frame.codes, frame.weights)
        # the frame is Morton-sorted; report positions in that order
        pos_parts.append(Vt[np.argsort(morton_codes_np(Vi, reader.depth), kind="stable")])
        attr_parts.append(rec)
    V = np.concatenate(pos_parts, axis=0)
    A = np.concatenate(attr_parts, axis=0)
    if roi is not None:
        lo = np.asarray(roi[0], dtype=np.int64)
        hi = np.asarray(roi[1], dtype=np.int64)
        keep = np.all((V >= lo) & (V < hi), axis=1)
        V, A = V[keep], A[keep]
    return V, A
