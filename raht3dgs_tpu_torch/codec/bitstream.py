"""R3TC frame container (counterpart of ``raht3dgs_tpu/codec/bitstream.py``).

Frames serialize to::

    magic 'R3TC' | u8 version | u8 flags | u8 depth | u16 n_channels |
    u64 n_voxels | u16 n_steps | f64 steps[n_steps] | f64 vmin[3] |
    f64 width | u32 channel_len[n_channels] | channel payloads...

``flags`` bit0: signed symbols; bits 1-2: coefficient order; bit 3: chunked
entropy payloads (a ``u32 chunk_size`` follows ``width``); bit 4: dead-zone
quantization (``f64 f, f64 delta`` follow); bit 5: inter frame, bit 6 its
probe set; bit 7: float32 transform. Version 3 adds a signalled-motion
section on inter frames, version 4 a lossless geometry section, version 5 a
second flag byte (per-channel entropy map, predicted-RAHT mask). The
layout is frozen: the port reads every container version the JAX package
writes (v1-v5) and writes the same bytes for the same fields. The R3TS
sequence container is not ported yet.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List

import numpy as np

MAGIC = b"R3TC"
# v2 = v1 layout + flag bits 4-7 (deadzone fields / inter / probe set /
# f32 transform dtype). Writers emit 2 so pre-v2 readers reject loudly
# instead of mis-parsing a deadzone header or silently returning an inter
# frame's residual as attributes; v1 streams still parse (bits unset).
VERSION = 2
# v3 = v2 layout + a SIGNALLED MOTION section on inter frames (u32 length
# + opaque bytes, between the deadzone fields and the channel-length
# table; models/temporal.py owns the payload format). v2 inter streams
# carry no motion bytes and decode by re-deriving the rev-1 motion
# pipeline from geometry; writers emit 3 only when motion bytes are
# present, so intra/v2 streams stay byte-identical to older writers.
VERSION_MOTION = 3
# v4 = v3 layout + a lossless GEOMETRY section (u32 length + opaque bytes,
# codec/geometry.py format) between the deadzone fields and the motion
# section. Emitted only when geometry is attached.
VERSION_GEOM = 4
# v5 = v4 layout + a second flag byte immediately after `flags` (the
# first byte is full). flags2 bit0: a per-channel ENTROPY MAP — a
# ceil(n_channels/8)-byte little-endian bitmask directly after flags2;
# bit c set means channel c's payload is a RAC stream (codec/rac.py)
# instead of RLGR. flags2 bit1: PREDICTED-RAHT coefficients
# (ops/praht.py) — a u32 predict_mask follows the entropy-map bytes
# (after flags2 itself when bit0 is unset). Unknown flags2 bits are a
# hard parse error (a future writer's stream must fail loudly, not
# decode garbage). Writers emit 5 only when some flags2 bit is actually
# set, so plain streams stay byte-identical to older writers; under v5
# the geometry section is always present (length 0 = none) and the
# motion section is always present on inter frames, mirroring the v4
# rules.
VERSION_ENTROPY = 5
FLAG2_ENTROPY_MAP = 1
FLAG2_PREDICT = 1 << 1
_READ_VERSIONS = (1, 2, 3, 4, 5)
FLAG_SIGNED = 1
# flags bits 1-2: coefficient order the encoder used (decoder must mirror it)
_ORDER_SHIFT = 1
# single source of truth for the mode <-> flag-bits mapping: the index is
# serialized into on-disk stream flags, so a second diverging tuple would
# silently corrupt streams
from raht3dgs_tpu_torch.ops.reorder import ORDER_MODES as _ORDER_MODES
FLAG_CHUNKED = 1 << 3
# bit 4: dead-zone quantization — two f64 metadata fields (encoder rounding
# offset f, decoder reconstruction offset delta) follow the chunk field.
# Streams without the bit carry no extra bytes, so default-mode containers
# are byte-identical to pre-deadzone writers.
FLAG_DEADZONE = 1 << 4
# bit 5: inter (predicted) frame — the payload codes the RESIDUAL against
# the neighbor-probe prediction from the previous frame's reconstruction
# (ops/temporal.py). No extra fields: the prediction is fully determined
# by the two frames' positions + the previous reconstruction, which the
# decoder has. Bit 6 of the flag byte carries the probe-set id
# (0 -> 7 probes, 1 -> 27) so the decoder replays the same probe set.
FLAG_INTER = 1 << 5
_PROBE_SHIFT = 6
_PROBE_SETS = (7, 27)
# bit 7: transform dtype was float32 (unset = float64). Recorded so the
# decoder can replay the encoder's precision — required for inter chains,
# whose closed loop needs bitwise-identical reconstructions on both sides.
FLAG_DTYPE32 = 1 << 7


@dataclass
class FrameStream:
    depth: int
    n_voxels: int
    steps: np.ndarray              # (1,) or (D,) float64
    channels: List[bytes]          # per-channel RLGR payloads
    vmin: np.ndarray = field(default_factory=lambda: np.zeros(3))
    width: float = 0.0
    signed: bool = True
    order_mode: str = "ragft"
    chunk: int = 0                 # >0: chunked (parallel) entropy layout
    quant_mode: str = "mid"        # "mid" (reference parity) | "deadzone"
    quant_f: float = 0.5           # dead-zone encoder rounding offset
    rec_delta: float = 0.0         # dead-zone reconstruction offset
    inter: bool = False            # payload is a prediction residual
    probes: int = 7                # inter probe set (7 | 27)
    dtype32: bool = False          # transform ran in float32 (else f64)
    motion: bytes = None           # signalled motion field (v3 inter)
    geometry: bytes = None         # lossless geometry section (v4)
    # per-channel entropy coder: None = all RLGR (pre-v5 byte layout);
    # else a length-n_channels tuple of bools, True = RAC (v5)
    entropy_map: tuple = None
    # inter-depth predicted RAHT (ops/praht.py): symbols are prediction
    # residuals; predict_mask bit d-1 set = depth d used prediction
    predict: bool = False
    predict_mask: int = 0

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    @property
    def num_bytes(self) -> int:
        return len(self.to_bytes())

    @property
    def payload_bytes(self) -> int:
        # signalled motion counts toward the rate: the adaptive inter/
        # intra decision and reported bpp must charge the side channel
        return sum(len(c) for c in self.channels) + (
            len(self.motion) if self.motion is not None else 0
        )

    def bpp(self) -> float:
        """Rate in bits per voxel over the attribute payload (the reference's
        rate metric, ``encode_ply.py:218`` — geometry is charged separately,
        matching the reference's decoder-has-geometry contract)."""
        return self.payload_bytes * 8.0 / max(self.n_voxels, 1)

    def geometry_bpp(self) -> float:
        """Rate of the lossless geometry section in bits per voxel (0.0 when
        the stream carries no geometry)."""
        if self.geometry is None:
            return 0.0
        return len(self.geometry) * 8.0 / max(self.n_voxels, 1)

    def total_bpp(self) -> float:
        """Attribute + geometry rate — the self-contained stream's bits per
        voxel (no out-of-band data)."""
        return self.bpp() + self.geometry_bpp()

    def to_bytes(self) -> bytes:
        steps = np.atleast_1d(np.asarray(self.steps, dtype=np.float64))
        if steps.shape[0] not in (1, self.n_channels):
            raise ValueError(
                f"steps must have 1 or {self.n_channels} entries, got {steps.shape}"
            )
        flags = FLAG_SIGNED if self.signed else 0
        flags |= _ORDER_MODES.index(self.order_mode) << _ORDER_SHIFT
        if self.chunk > 0:
            flags |= FLAG_CHUNKED
        if self.quant_mode == "deadzone":
            flags |= FLAG_DEADZONE
        elif self.quant_mode != "mid":
            raise ValueError(f"unknown quant_mode {self.quant_mode!r}")
        if self.inter:
            flags |= FLAG_INTER
            flags |= _PROBE_SETS.index(self.probes) << _PROBE_SHIFT
        if self.dtype32:
            flags |= FLAG_DTYPE32
        emap = None
        if self.entropy_map is not None and any(self.entropy_map):
            emap = tuple(bool(b) for b in self.entropy_map)
            if len(emap) != self.n_channels:
                raise ValueError(
                    f"entropy_map has {len(emap)} entries for "
                    f"{self.n_channels} channels"
                )
        if emap is not None or self.predict:
            version = VERSION_ENTROPY
        elif self.geometry is not None:
            version = VERSION_GEOM
        elif self.inter and self.motion is not None:
            version = VERSION_MOTION
        else:
            version = VERSION
        head = struct.pack(
            "<4sBBBHQH",
            MAGIC,
            version,
            flags,
            self.depth,
            self.n_channels,
            self.n_voxels,
            steps.shape[0],
        )
        if version >= VERSION_ENTROPY:
            flags2 = (FLAG2_ENTROPY_MAP if emap is not None else 0) | (
                FLAG2_PREDICT if self.predict else 0
            )
            head += struct.pack("<B", flags2)
            if emap is not None:
                bits = bytearray((self.n_channels + 7) // 8)
                for c, is_rac in enumerate(emap):
                    if is_rac:
                        bits[c // 8] |= 1 << (c % 8)
                head += bytes(bits)
            if self.predict:
                if not 0 <= self.predict_mask < (1 << 32):
                    raise ValueError(
                        f"predict_mask {self.predict_mask:#x} does not fit "
                        "u32"
                    )
                head += struct.pack("<I", self.predict_mask)
        head += steps.tobytes()
        vmin = np.asarray(self.vmin, dtype=np.float64)
        if vmin.shape != (3,):
            raise ValueError(f"vmin must have shape (3,), got {vmin.shape}")
        head += vmin.tobytes()
        head += struct.pack("<d", float(self.width))
        if self.chunk > 0:
            head += struct.pack("<I", int(self.chunk))
        if self.quant_mode == "deadzone":
            head += struct.pack("<dd", float(self.quant_f),
                                float(self.rec_delta))
        # v5 always carries the geometry length field (0 = none) so the
        # reader's version>=4 section walk stays uniform
        if self.geometry is not None or version >= VERSION_ENTROPY:
            head += struct.pack("<I", len(self.geometry or b""))
            head += self.geometry or b""
        # v3 emits a motion section only when motion exists (version
        # selection guarantees it); v4/v5 streams may be inter WITHOUT
        # signalled motion (derived-motion v2 semantics + geometry), so
        # from v4 on the section is always present on inter frames and a
        # zero length means "derived" — otherwise the reader would consume
        # the channel-length table as motion bytes
        if self.inter and (self.motion is not None
                           or version >= VERSION_GEOM):
            head += struct.pack("<I", len(self.motion or b""))
            head += self.motion or b""
        head += struct.pack(f"<{self.n_channels}I", *[len(c) for c in self.channels])
        return head + b"".join(self.channels)

    @classmethod
    def from_bytes(cls, data: bytes) -> "FrameStream":
        off = struct.calcsize("<4sBBBHQH")
        if len(data) < off:
            raise ValueError(
                f"truncated stream: {len(data)} bytes, header needs {off}"
            )
        magic, version, flags, depth, n_ch, n_vox, n_steps = struct.unpack(
            "<4sBBBHQH", data[:off]
        )
        if magic != MAGIC:
            raise ValueError(f"bad magic {magic!r}")
        if version not in _READ_VERSIONS:
            raise ValueError(f"unsupported version {version}")
        order_bits = (flags >> _ORDER_SHIFT) & 0x3
        if order_bits >= len(_ORDER_MODES):
            raise ValueError(f"corrupt stream: unknown order mode {order_bits}")
        if n_steps not in (1, n_ch) or n_steps == 0:
            raise ValueError(
                f"corrupt stream: {n_steps} steps for {n_ch} channels "
                "(must be 1 or one per channel)"
            )
        entropy_map = None
        predict = False
        predict_mask = 0
        if version >= VERSION_ENTROPY:
            if len(data) < off + 1:
                raise ValueError("truncated stream: flags2 byte cut off")
            flags2 = data[off]
            off += 1
            if flags2 & ~(FLAG2_ENTROPY_MAP | FLAG2_PREDICT):
                raise ValueError(
                    f"corrupt stream: unknown flags2 bits 0x{flags2:02x}"
                )
            if flags2 & FLAG2_ENTROPY_MAP:
                nb = (n_ch + 7) // 8
                if len(data) < off + nb:
                    raise ValueError(
                        "truncated stream: entropy map cut off"
                    )
                entropy_map = tuple(
                    bool(data[off + c // 8] >> (c % 8) & 1)
                    for c in range(n_ch)
                )
                off += nb
            if flags2 & FLAG2_PREDICT:
                if len(data) < off + 4:
                    raise ValueError(
                        "truncated stream: predict mask cut off"
                    )
                predict = True
                (predict_mask,) = struct.unpack(
                    "<I", data[off : off + 4]
                )
                off += 4
        fixed = (8 * n_steps + 24 + 8 + (4 if flags & FLAG_CHUNKED else 0)
                 + (16 if flags & FLAG_DEADZONE else 0))
        if len(data) < off + fixed:
            raise ValueError("truncated stream: metadata section cut off")
        steps = np.frombuffer(data[off : off + 8 * n_steps], dtype=np.float64).copy()
        off += 8 * n_steps
        vmin = np.frombuffer(data[off : off + 24], dtype=np.float64).copy()
        off += 24
        (width,) = struct.unpack("<d", data[off : off + 8])
        off += 8
        chunk = 0
        if flags & FLAG_CHUNKED:
            (chunk,) = struct.unpack("<I", data[off : off + 4])
            off += 4
        quant_f, rec_delta = 0.5, 0.0
        if flags & FLAG_DEADZONE:
            quant_f, rec_delta = struct.unpack("<dd", data[off : off + 16])
            off += 16
        geometry = None
        if version >= 4:
            if len(data) < off + 4:
                raise ValueError("truncated stream: geometry length cut off")
            (glen,) = struct.unpack("<I", data[off : off + 4])
            off += 4
            if len(data) < off + glen:
                raise ValueError("truncated stream: geometry section cut off")
            # v5 writers always emit the field; 0 means "no geometry"
            geometry = data[off : off + glen] if glen else None
            off += glen
        motion = None
        if version >= 3 and flags & FLAG_INTER:
            if len(data) < off + 4:
                raise ValueError("truncated stream: motion length cut off")
            (mlen,) = struct.unpack("<I", data[off : off + 4])
            off += 4
            if len(data) < off + mlen:
                raise ValueError("truncated stream: motion section cut off")
            # zero length = inter frame with DERIVED motion (v4 writers
            # always emit the section on inter frames)
            motion = data[off : off + mlen] if mlen else None
            off += mlen
        if len(data) < off + 4 * n_ch:
            raise ValueError("truncated stream: channel length table cut off")
        lens = struct.unpack(f"<{n_ch}I", data[off : off + 4 * n_ch])
        off += 4 * n_ch
        if len(data) < off + sum(lens):
            raise ValueError(
                f"truncated stream: payloads need {off + sum(lens)} bytes, "
                f"have {len(data)}"
            )
        channels = []
        for ln in lens:
            channels.append(data[off : off + ln])
            off += ln
        return cls(
            depth=depth,
            n_voxels=n_vox,
            steps=steps,
            channels=channels,
            vmin=vmin,
            width=width,
            signed=bool(flags & FLAG_SIGNED),
            order_mode=_ORDER_MODES[order_bits],
            chunk=chunk,
            quant_mode="deadzone" if flags & FLAG_DEADZONE else "mid",
            quant_f=quant_f,
            rec_delta=rec_delta,
            inter=bool(flags & FLAG_INTER),
            probes=_PROBE_SETS[(flags >> _PROBE_SHIFT) & 0x1],
            dtype32=bool(flags & FLAG_DTYPE32),
            motion=motion,
            geometry=geometry,
            entropy_map=entropy_map,
            predict=predict,
            predict_mask=predict_mask,
        )
