"""Lossless geometry coding: octree occupancy and a binary range coder.

Counterpart of ``raht3dgs_tpu/codec/geometry.py``. A frame's sorted unique
Morton codes are serialized as octree occupancy bytes (``ops/octree.py``)
and entropy-coded with an adaptive binary range coder, so a stream can
carry its own positions (about 1-3 bits a voxel on surface-like clouds).

The coder is the port's own byte-identical copy of ``native/geom.cpp``
(the automaton is a frozen stream format), built with g++ into
``_build/``; a failed build raises. The plain twin ``codec/_geom_py.py``
runs only when a caller names it (``backend="python"``). All six profiles
are read and written: 0 intra, 1 temporal, 2 temporal with motion, and
3-5 the same with ext3 contexts. Positions are Morton-decoded on the
device (CUDA unless ``device="cpu"``) and returned as numpy.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from typing import Optional

import numpy as np
import torch

from raht3dgs_tpu_torch.codec import _geom_py
from raht3dgs_tpu_torch.codec._native import NativeLib, gxx_command
from raht3dgs_tpu_torch.ops.morton import morton_codes_np, morton_decode, morton_encode
from raht3dgs_tpu_torch.ops.octree import (
    _BITS8,
    level_neighbors6,
    octree_deserialize,
    octree_levels,
    octree_serialize,
)
from raht3dgs_tpu_torch.utils.device import DeviceLike, resolve_device

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)


def _configure(lib: ctypes.CDLL) -> None:
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    lib.geom_encode.argtypes = [
        pu8, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.POINTER(pu8), ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.geom_encode.restype = ctypes.c_int
    lib.geom_decode.argtypes = [
        pu8, ctypes.c_size_t, ctypes.c_size_t,
        pu8, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.geom_decode.restype = ctypes.c_int
    lib.geom_buffer_free.argtypes = [pu8]
    lib.geom_buffer_free.restype = None
    # temporal (profile 1) stateful API
    lib.geom_enc_new.argtypes = []
    lib.geom_enc_new.restype = ctypes.c_void_p
    lib.geom_enc_level.argtypes = [
        ctypes.c_void_p, pu8, pu8, pu8, ctypes.c_size_t, ctypes.c_size_t,
    ]
    lib.geom_enc_level.restype = ctypes.c_int
    lib.geom_enc_finish.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(pu8), ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.geom_enc_finish.restype = ctypes.c_int
    lib.geom_enc_free.argtypes = [ctypes.c_void_p]
    lib.geom_enc_free.restype = None
    lib.geom_dec_new.argtypes = [pu8, ctypes.c_size_t]
    lib.geom_dec_new.restype = ctypes.c_void_p
    lib.geom_dec_level.argtypes = [
        ctypes.c_void_p, pu8, pu8, ctypes.c_size_t, ctypes.c_size_t, pu8,
    ]
    lib.geom_dec_level.restype = ctypes.c_int
    lib.geom_dec_free.argtypes = [ctypes.c_void_p]
    lib.geom_dec_free.restype = None
    lib.geom_decode_codes.argtypes = [
        pu8, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.geom_decode_codes.restype = ctypes.c_int
    lib.geom_encode_codes.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t, ctypes.c_size_t,
        ctypes.POINTER(pu8), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.geom_encode_codes.restype = ctypes.c_int
    # ext3-context profiles (3-5): fused intra + temporal level APIs
    lib.geom_encode_codes3.argtypes = lib.geom_encode_codes.argtypes
    lib.geom_encode_codes3.restype = ctypes.c_int
    lib.geom_decode_codes3.argtypes = lib.geom_decode_codes.argtypes
    lib.geom_decode_codes3.restype = ctypes.c_int
    lib.geom_enc_new4.argtypes = []
    lib.geom_enc_new4.restype = ctypes.c_void_p
    lib.geom_enc_level4.argtypes = [
        ctypes.c_void_p, pu8, pu8, pu8, pu8, ctypes.c_size_t,
        ctypes.c_size_t,
    ]
    lib.geom_enc_level4.restype = ctypes.c_int
    lib.geom_dec_new4.argtypes = [pu8, ctypes.c_size_t]
    lib.geom_dec_new4.restype = ctypes.c_void_p
    lib.geom_dec_level4.argtypes = [
        ctypes.c_void_p, pu8, pu8, pu8, ctypes.c_size_t, ctypes.c_size_t,
        pu8,
    ]
    lib.geom_dec_level4.restype = ctypes.c_int
    # LOD (level-prefix) intra decodes
    lib.geom_decode_codes_lod.argtypes = [
        pu8, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.geom_decode_codes_lod.restype = ctypes.c_int
    lib.geom_decode_codes3_lod.argtypes = lib.geom_decode_codes_lod.argtypes
    lib.geom_decode_codes3_lod.restype = ctypes.c_int


NATIVE = NativeLib(os.path.join(_NATIVE_DIR, "geom.cpp"), "libgeom.so", _configure,
                   gxx_command, deps=(os.path.join(_NATIVE_DIR, "range_coder.h"),))
BACKENDS = ("native", "python")


def _use_native(backend: str) -> bool:
    """True for the native library (loaded here; a failed build raises),
    False for the plain twin."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown geometry backend {backend!r} (choose from {BACKENDS})")
    if backend == "native":
        NATIVE.load()
        return True
    return False


def _encode_occ(occ: np.ndarray, depth: int, backend: str) -> bytes:
    occ = np.ascontiguousarray(occ, dtype=np.uint8)
    if _use_native(backend):
        lib = NATIVE.load()
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        rc = lib.geom_encode(
            occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            occ.size, depth, ctypes.byref(out), ctypes.byref(out_len),
        )
        if rc != 0:
            raise ValueError(f"geometry encode failed (rc={rc})")
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            lib.geom_buffer_free(out)
    return _geom_py.encode(occ, depth)


def _decode_occ(data: bytes, depth: int, max_bytes: int, backend: str) -> np.ndarray:
    if _use_native(backend):
        lib = NATIVE.load()
        buf = np.frombuffer(data, dtype=np.uint8)
        buf = np.ascontiguousarray(buf)
        out = np.empty(max_bytes, dtype=np.uint8)
        out_n = ctypes.c_size_t()
        rc = lib.geom_decode(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
            depth,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
            ctypes.byref(out_n),
        )
        if rc != 0:
            raise ValueError(
                f"geometry decode failed (rc={rc}): corrupt stream or "
                "capacity overflow"
            )
        return out[: out_n.value]
    return _geom_py.decode(data, depth, max_bytes)


# Section layout: u8 profile | u32 crc32(occupancy bytes) | profile
# extras | coder bytes. The CRC makes corruption/wrong-reference detection
# DETERMINISTIC — the entropy payload itself has no redundancy, and the
# structural checks alone are only probabilistic. The crc32 field is part
# of each profile's DEFINITION: profiles 0-2 shipped with it (the brief
# intra-round pre-CRC layout never left this repository and is not a
# readable format; from here on, layout changes bump the profile byte).
# Profile 0 = the intra automaton frozen in native/geom.cpp /
# _geom_py.py; profile 1 = the temporal coder (contexts from the previous
# frame's decoded octree — the decoder MUST be handed prev_codes). Better
# context models can be added as new profiles without touching the
# container format.
_PROFILE_V0 = 0
_PROFILE_V1_TEMPORAL = 1
_CRC_HEAD = struct.Struct("<I")


def _check_n_voxels(n_voxels: int, depth: int) -> None:
    """Reject physically impossible header counts before sizing anything
    by them (a flipped header byte must never turn into a giant
    allocation — ValueError at worst, the container contract)."""
    if n_voxels > 8 ** depth:
        raise ValueError(
            f"corrupt stream: {n_voxels} voxels exceeds the 8^{depth} "
            "cells of the voxel grid"
        )
# profile 2 = temporal with a motion-compensated reference: 3x i32 global
# motion follows the profile byte; the previous frame's codes are shifted
# by it (shared _shift_codes helper — bitwise identical both sides) before
# node matching.
_PROFILE_V2_TEMPORAL_MC = 2
_MC_HEAD = struct.Struct("<3i")

# Profiles 3-5 = the ext3-context family (same layouts as 0-2 otherwise):
# every occupancy bit is additionally conditioned on the same-level
# face-neighbor occupancy of the child's three outward sides
# (ops/octree.py:level_neighbors6). The JAX package measured their rates
# on scan-like statistics (its scripts/exp_geom_contexts.py): -23% intra
# and -20% temporal at J=10 against profiles 0/1, but more bits on small
# frames (a crossover near 16-20k voxels), so the default is size-adaptive
# — a free encoder-side choice, the profile byte is signalled per section. RAHT3DGS_GEOM_CONTEXTS forces ext3/legacy.
# All six profiles decode forever.
_PROFILE_V3_INTRA_EXT = 3
_PROFILE_V4_TEMPORAL_EXT = 4
_PROFILE_V5_TEMPORAL_MC_EXT = 5
_EXT3_AUTO_MIN = 16384


def _resolve_ext3(n_voxels: int, ext3) -> bool:
    if ext3 is not None:
        return bool(ext3)
    mode = os.environ.get("RAHT3DGS_GEOM_CONTEXTS", "auto")
    if mode == "legacy":
        return False
    if mode == "ext3":
        return True
    return n_voxels >= _EXT3_AUTO_MIN


def _shift_codes(codes: np.ndarray, depth: int, mv) -> np.ndarray:
    """Translate a code set by an integer vector (clip to the grid, dedup).

    Frozen stream semantics for profiles 2 and 5: encoder and decoder must
    shift the reference identically (host tensors: a few thousand to a few
    million codes, once a frame)."""
    V = morton_decode(torch.as_tensor(np.asarray(codes).astype(np.int64)), depth)
    V = torch.clamp(V + torch.as_tensor(np.asarray(mv, dtype=np.int64)), 0, (1 << depth) - 1)
    return np.unique(morton_encode(V, depth).numpy())


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class _NativeTemporalEncoder:
    def __init__(self):
        self._lib = NATIVE.load()
        self._h = self._lib.geom_enc_new()
        if not self._h:
            raise MemoryError("geom_enc_new failed")

    def encode_level(self, occ, matched, prevbyte, level):
        occ = np.ascontiguousarray(occ, dtype=np.uint8)
        matched = np.ascontiguousarray(matched, dtype=np.uint8)
        prevbyte = np.ascontiguousarray(prevbyte, dtype=np.uint8)
        rc = self._lib.geom_enc_level(
            self._h, _u8ptr(occ), _u8ptr(matched), _u8ptr(prevbyte),
            occ.size, level,
        )
        if rc != 0:
            raise ValueError(f"temporal geometry encode failed (rc={rc})")

    def finish(self) -> bytes:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        rc = self._lib.geom_enc_finish(
            self._h, ctypes.byref(out), ctypes.byref(out_len)
        )
        if rc != 0:
            raise MemoryError("geom_enc_finish failed")
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._lib.geom_buffer_free(out)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.geom_enc_free(self._h)
            self._h = None


class _NativeTemporalEncoder4:
    """Profiles 4-5: the ext3-context temporal encoder (n6 per level)."""

    def __init__(self):
        self._lib = NATIVE.load()
        self._h = self._lib.geom_enc_new4()
        if not self._h:
            raise MemoryError("geom_enc_new4 failed")

    def encode_level(self, occ, matched, prevbyte, n6, level):
        occ = np.ascontiguousarray(occ, dtype=np.uint8)
        matched = np.ascontiguousarray(matched, dtype=np.uint8)
        prevbyte = np.ascontiguousarray(prevbyte, dtype=np.uint8)
        n6 = np.ascontiguousarray(n6, dtype=np.uint8)
        rc = self._lib.geom_enc_level4(
            self._h, _u8ptr(occ), _u8ptr(matched), _u8ptr(prevbyte),
            _u8ptr(n6), occ.size, level,
        )
        if rc != 0:
            raise ValueError(f"temporal geometry encode failed (rc={rc})")

    finish = _NativeTemporalEncoder.finish
    __del__ = _NativeTemporalEncoder.__del__


class _NativeTemporalDecoder:
    def __init__(self, buf: bytes):
        self._lib = NATIVE.load()
        # the handle keeps a pointer into the buffer: hold a reference
        self._buf = np.ascontiguousarray(np.frombuffer(buf, dtype=np.uint8))
        self._h = self._lib.geom_dec_new(_u8ptr(self._buf), self._buf.size)
        if not self._h:
            raise MemoryError("geom_dec_new failed")

    def decode_level(self, matched, prevbyte, n, level):
        matched = np.ascontiguousarray(matched, dtype=np.uint8)
        prevbyte = np.ascontiguousarray(prevbyte, dtype=np.uint8)
        out = np.empty(n, dtype=np.uint8)
        rc = self._lib.geom_dec_level(
            self._h, _u8ptr(matched), _u8ptr(prevbyte), n, level, _u8ptr(out)
        )
        if rc != 0:
            raise ValueError(f"temporal geometry decode failed (rc={rc})")
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.geom_dec_free(self._h)
            self._h = None


class _NativeTemporalDecoder4:
    """Decoder counterpart of :class:`_NativeTemporalEncoder4`."""

    def __init__(self, buf: bytes):
        self._lib = NATIVE.load()
        # the handle keeps a pointer into the buffer: hold a reference
        self._buf = np.ascontiguousarray(np.frombuffer(buf, dtype=np.uint8))
        self._h = self._lib.geom_dec_new4(_u8ptr(self._buf), self._buf.size)
        if not self._h:
            raise MemoryError("geom_dec_new4 failed")

    def decode_level(self, matched, prevbyte, n6, n, level):
        matched = np.ascontiguousarray(matched, dtype=np.uint8)
        prevbyte = np.ascontiguousarray(prevbyte, dtype=np.uint8)
        n6 = np.ascontiguousarray(n6, dtype=np.uint8)
        out = np.empty(n, dtype=np.uint8)
        rc = self._lib.geom_dec_level4(
            self._h, _u8ptr(matched), _u8ptr(prevbyte), _u8ptr(n6), n,
            level, _u8ptr(out),
        )
        if rc != 0:
            raise ValueError(f"temporal geometry decode failed (rc={rc})")
        return out

    __del__ = _NativeTemporalDecoder.__del__


def _match_level(cur_codes, prev_codes, prev_occ):
    """Align current-level nodes with the previous frame's same-level nodes
    (both sorted): per cur node, (matched flag, previous occupancy byte)."""
    if prev_codes.size == 0:
        z = np.zeros(cur_codes.size, dtype=np.uint8)
        return z, z
    idx = np.minimum(
        np.searchsorted(prev_codes, cur_codes), prev_codes.size - 1
    )
    matched = prev_codes[idx] == cur_codes
    pb = np.where(matched, prev_occ[idx], 0)
    return matched.astype(np.uint8), pb.astype(np.uint8)


def _validated_u64(codes: np.ndarray, depth: int) -> np.ndarray:
    """Range/dtype validation shared by the fused intra paths (the
    sortedness check happens in C / in octree_levels)."""
    c = np.asarray(codes)
    if c.ndim != 1 or c.size == 0:
        raise ValueError("codes must be a non-empty 1-D array")
    if c.dtype.kind == "i" and np.any(c < 0):
        raise ValueError("negative Morton codes")
    u = np.ascontiguousarray(c.astype(np.uint64))
    if np.any(u >= np.uint64(1) << np.uint64(min(3 * depth, 63))):
        if 3 * depth < 64:
            raise ValueError(f"codes exceed 3*depth = {3 * depth} bits")
    return u


def _encode_intra_fused(codes: np.ndarray, depth: int, ext3: bool) -> bytes:
    """Fused native intra path: level build + entropy (+ n6 for profile 3)
    in one call."""
    u = _validated_u64(codes, depth)
    lib = NATIVE.load()
    fn = lib.geom_encode_codes3 if ext3 else lib.geom_encode_codes
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    crc = ctypes.c_uint32()
    rc = fn(
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), u.size,
        depth, ctypes.byref(out), ctypes.byref(out_len), ctypes.byref(crc),
    )
    if rc == -2:
        raise ValueError(
            "geometry encode failed: codes must be sorted "
            "strictly increasing (and depth/count nonzero)"
        )
    if rc != 0:
        raise MemoryError(f"geometry encode failed (rc={rc})")
    try:
        payload = ctypes.string_at(out, out_len.value)
    finally:
        lib.geom_buffer_free(out)
    profile = _PROFILE_V3_INTRA_EXT if ext3 else _PROFILE_V0
    return bytes([profile]) + _CRC_HEAD.pack(crc.value) + payload


def encode_geometry(
    codes: np.ndarray, depth: int,
    prev_codes: Optional[np.ndarray] = None, motion=None,
    ext3: Optional[bool] = None, backend: str = "native",
) -> bytes:
    """Sorted unique Morton codes -> self-contained geometry section bytes.

    With ``prev_codes`` (the previous frame's codes at the SAME depth), the
    section is coded with a temporal profile: per-bit contexts gain the
    matched previous-frame node's occupancy bit. The decoder must then be handed the same
    ``prev_codes`` (its own previous decode — the chain is closed-loop
    lossless). ``motion`` (3 ints, e.g. the sequence codec's signalled
    global motion) additionally shifts the reference before matching (the
    vector rides the section).

    ``ext3`` selects the context family: True = profiles 3-5 (same-level
    face-neighbor contexts), False = legacy profiles 0-2, None (default) =
    size-adaptive (>= 16384 voxels, the JAX package's measured crossover;
    override with RAHT3DGS_GEOM_CONTEXTS
    = ext3|legacy, the same values as the JAX package's). The decoder
    reads all profiles regardless. ``backend="python"`` codes through the
    plain twin.
    """
    ext3 = _resolve_ext3(np.asarray(codes).size, ext3)
    native = _use_native(backend)
    if prev_codes is None:
        if native:
            return _encode_intra_fused(codes, depth, ext3)
        if ext3:
            payload, crc = _geom_py.encode3(
                _validated_u64(codes, depth), depth
            )
            return (bytes([_PROFILE_V3_INTRA_EXT]) + _CRC_HEAD.pack(crc)
                    + payload)
        occ = octree_serialize(codes, depth)
        return (bytes([_PROFILE_V0])
                + _CRC_HEAD.pack(zlib.crc32(occ.tobytes()))
                + _encode_occ(occ, depth, backend))
    head = bytes(
        [_PROFILE_V4_TEMPORAL_EXT if ext3 else _PROFILE_V1_TEMPORAL]
    )
    if motion is not None:
        mv = np.asarray(motion, dtype=np.int64).reshape(3)
        if np.any(mv != 0):
            head = bytes(
                [_PROFILE_V5_TEMPORAL_MC_EXT if ext3
                 else _PROFILE_V2_TEMPORAL_MC]
            ) + _MC_HEAD.pack(int(mv[0]), int(mv[1]), int(mv[2]))
            prev_codes = _shift_codes(prev_codes, depth, mv)
    lv_cur, occ_cur = octree_levels(codes, depth)
    lv_prev, occ_prev = octree_levels(prev_codes, depth)
    if ext3:
        enc = (
            _NativeTemporalEncoder4()
            if native
            else _geom_py.TemporalEncoder4()
        )
        for l in range(depth):
            matched, pb = _match_level(lv_cur[l], lv_prev[l], occ_prev[l])
            n6 = level_neighbors6(lv_cur[l], l)
            enc.encode_level(occ_cur[l], matched, pb, n6, l)
    else:
        enc = (
            _NativeTemporalEncoder()
            if native
            else _geom_py.TemporalEncoder()
        )
        for l in range(depth):
            matched, pb = _match_level(lv_cur[l], lv_prev[l], occ_prev[l])
            enc.encode_level(occ_cur[l], matched, pb, l)
    crc = zlib.crc32(np.concatenate(occ_cur).tobytes())
    # the CRC sits right after the profile byte, before the motion extras
    return head[:1] + _CRC_HEAD.pack(crc) + head[1:] + enc.finish()


def codes_from_positions(V: np.ndarray, depth: int) -> np.ndarray:
    """Unique integer voxel positions (any row order) -> sorted Morton codes."""
    Vint = np.floor(np.asarray(V)).astype(np.int64)
    codes = np.sort(morton_codes_np(Vint, depth))
    if codes.size > 1 and np.any(codes[1:] == codes[:-1]):
        raise ValueError(
            "duplicate voxel positions — geometry coding needs the same "
            "deduplicated input the attribute codec does"
        )
    return codes


def geometry_from_positions(
    V: np.ndarray, depth: int, prev_codes: Optional[np.ndarray] = None
) -> bytes:
    """Geometry section from unique integer voxel positions (any row order).

    Convenience for the CLI drivers: positions -> sorted Morton codes ->
    :func:`encode_geometry`. The decoder reconstructs the SET of positions
    (in Morton order); per-point attribute rows are stored Morton-sorted in
    the stream anyway, so nothing else is needed for a self-contained
    decode (``cli/decode.py``). ``prev_codes`` selects the temporal profile
    (sequence encoders only — the decoder replays the chain in order).
    """
    return encode_geometry(codes_from_positions(V, depth),
                           depth, prev_codes=prev_codes)


def positions_from_geometry(
    data: bytes, depth: int, n_voxels: int, *, device: DeviceLike = None
) -> np.ndarray:
    """Inverse of :func:`geometry_from_positions`: section bytes ->
    ``(N, 3)`` int64 voxel positions in Morton order (Morton-decoded on
    CUDA unless ``device="cpu"``)."""
    codes = decode_geometry(data, depth, n_voxels)
    return _positions(codes, depth, device)


def _positions(codes: np.ndarray, depth: int, device: DeviceLike) -> np.ndarray:
    dev = resolve_device(device)
    return morton_decode(torch.as_tensor(codes, device=dev), depth).cpu().numpy() \
        .astype(np.int64)


def decode_geometry(
    data: bytes, depth: int, n_voxels: int, dtype=None,
    prev_codes: Optional[np.ndarray] = None, backend: str = "native",
) -> np.ndarray:
    """Geometry section bytes -> sorted unique Morton codes.

    ``n_voxels`` (from the container header) bounds the decode walk and is
    cross-checked against the decoded leaf count — a mismatch means a
    corrupt stream and raises rather than returning wrong geometry.
    Temporal-profile sections additionally need ``prev_codes`` (the
    previously decoded frame's codes at the same depth).
    """
    if n_voxels < 1:
        raise ValueError(f"n_voxels must be >= 1, got {n_voxels}")
    _check_n_voxels(n_voxels, depth)
    if len(data) < 1 + _CRC_HEAD.size:
        raise ValueError("empty or truncated geometry section")
    (crc,) = _CRC_HEAD.unpack(data[1 : 1 + _CRC_HEAD.size])
    body = data[1 + _CRC_HEAD.size :]
    if data[0] in (_PROFILE_V1_TEMPORAL, _PROFILE_V4_TEMPORAL_EXT):
        return _decode_temporal(body, depth, n_voxels, dtype, prev_codes,
                                crc, backend,
                                ext3=data[0] == _PROFILE_V4_TEMPORAL_EXT)
    if data[0] in (_PROFILE_V2_TEMPORAL_MC, _PROFILE_V5_TEMPORAL_MC_EXT):
        if len(body) < _MC_HEAD.size:
            raise ValueError("truncated geometry section: motion cut off")
        mv = _MC_HEAD.unpack(body[: _MC_HEAD.size])
        if prev_codes is not None:
            prev_codes = _shift_codes(prev_codes, depth, mv)
        return _decode_temporal(
            body[_MC_HEAD.size :], depth, n_voxels, dtype, prev_codes, crc,
            backend, ext3=data[0] == _PROFILE_V5_TEMPORAL_MC_EXT,
        )
    ext3 = data[0] == _PROFILE_V3_INTRA_EXT
    if data[0] not in (_PROFILE_V0, _PROFILE_V3_INTRA_EXT):
        raise ValueError(f"unknown geometry coder profile {data[0]}")
    if _use_native(backend):
        # fused native path: entropy decode + leaf-code rebuild in one
        # pass (the two-stage path's numpy bit-matrix expansion costs
        # more than the entropy decode itself), crc computed in-stream
        lib = NATIVE.load()
        fn = lib.geom_decode_codes3 if ext3 else lib.geom_decode_codes
        buf = np.ascontiguousarray(np.frombuffer(body, dtype=np.uint8))
        try:
            out = np.empty(n_voxels, dtype=np.uint64)
        except MemoryError:
            raise ValueError(
                "corrupt geometry stream: decode exceeded plausible memory"
            )
        out_n = ctypes.c_size_t()
        crc_got = ctypes.c_uint32()
        rc = fn(
            _u8ptr(buf), buf.size, depth,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), out.size,
            ctypes.byref(out_n), ctypes.byref(crc_got),
        )
        if rc != 0:
            raise ValueError(
                f"geometry decode failed (rc={rc}): corrupt stream or "
                "capacity overflow"
            )
        if crc_got.value != crc:
            raise ValueError(
                "corrupt geometry stream: occupancy checksum mismatch"
            )
        if int(out_n.value) != n_voxels:
            raise ValueError(
                f"corrupt geometry stream: decoded {int(out_n.value)} "
                f"voxels, header says {n_voxels}"
            )
        if dtype is None:
            dtype = np.int32 if depth <= 10 else np.int64
        codes = out.astype(dtype)
        if np.dtype(dtype) != np.uint64 and np.any(
            codes.astype(np.uint64) != out
        ):
            raise ValueError(f"decoded codes overflow dtype {np.dtype(dtype)}")
        return codes
    if ext3:
        try:
            out, crc_got = _geom_py.decode3(body, depth, n_voxels)
        except MemoryError:
            raise ValueError(
                "corrupt geometry stream: decode exceeded plausible memory"
            )
        if crc_got != crc:
            raise ValueError(
                "corrupt geometry stream: occupancy checksum mismatch"
            )
        if out.size != n_voxels:
            raise ValueError(
                f"corrupt geometry stream: decoded {out.size} voxels, "
                f"header says {n_voxels}"
            )
        if dtype is None:
            dtype = np.int32 if depth <= 10 else np.int64
        codes = out.astype(dtype)
        if np.dtype(dtype) != np.uint64 and np.any(
            codes.astype(np.uint64) != out
        ):
            raise ValueError(f"decoded codes overflow dtype {np.dtype(dtype)}")
        return codes
    # every voxel contributes at most one internal node per level
    max_bytes = n_voxels * depth + 1
    try:
        occ = _decode_occ(body, depth, max_bytes, backend)
    except MemoryError:
        raise ValueError(
            "corrupt geometry stream: decode exceeded plausible memory"
        )
    if zlib.crc32(occ.tobytes()) != crc:
        raise ValueError(
            "corrupt geometry stream: occupancy checksum mismatch"
        )
    if dtype is None:
        # match morton_encode's output tier (ops/morton.py): int32 through
        # J=10, int64 above (J=21 codes fit 63 bits)
        dtype = np.int32 if depth <= 10 else np.int64
    codes = octree_deserialize(occ, depth, dtype=dtype)
    if codes.size != n_voxels:
        raise ValueError(
            f"corrupt geometry stream: decoded {codes.size} voxels, "
            f"header says {n_voxels}"
        )
    return codes


def decode_geometry_lod(
    data: bytes, depth: int, n_voxels: int, level: int, dtype=None,
    prev_codes: Optional[np.ndarray] = None, backend: str = "native",
) -> np.ndarray:
    """Level-of-detail geometry decode: section bytes -> the sorted unique
    Morton codes of the octree nodes AT depth ``level`` (coarse positions
    on the 2^level grid).

    Breadth-first occupancy makes a level cut a stream *prefix*: the range
    decoder walks levels 0..level-1 and stops, skipping the deep levels
    that dominate both the stream and the decode work — the geometry
    counterpart of the attribute codec's ``decode_lod``
    (models/pipeline.py), for previews where only positions are needed.
    Cost scales with the node count at the cut (~8x per level), not with
    ``n_voxels``.

    ``level == depth`` delegates to the full :func:`decode_geometry`
    (checksum-verified). Partial decodes cannot verify the stream CRC
    (it covers the full walk); the per-level capacity bound against
    ``n_voxels`` still applies. Temporal-profile sections need
    ``prev_codes`` (the previous frame's FULL-depth codes).
    """
    if not 1 <= level <= depth:
        raise ValueError(f"lod level must be in 1..{depth}, got {level}")
    if level == depth:
        return decode_geometry(data, depth, n_voxels, dtype=dtype,
                               prev_codes=prev_codes, backend=backend)
    if n_voxels < 1:
        raise ValueError(f"n_voxels must be >= 1, got {n_voxels}")
    _check_n_voxels(n_voxels, depth)
    if len(data) < 1 + _CRC_HEAD.size:
        raise ValueError("empty or truncated geometry section")
    (crc,) = _CRC_HEAD.unpack(data[1 : 1 + _CRC_HEAD.size])
    body = data[1 + _CRC_HEAD.size :]
    if dtype is None:
        dtype = np.int32 if level <= 10 else np.int64
    if data[0] in (_PROFILE_V1_TEMPORAL, _PROFILE_V4_TEMPORAL_EXT):
        return _decode_temporal(
            body, depth, n_voxels, dtype, prev_codes, crc, backend,
            ext3=data[0] == _PROFILE_V4_TEMPORAL_EXT, max_level=level,
        )
    if data[0] in (_PROFILE_V2_TEMPORAL_MC, _PROFILE_V5_TEMPORAL_MC_EXT):
        if len(body) < _MC_HEAD.size:
            raise ValueError("truncated geometry section: motion cut off")
        mv = _MC_HEAD.unpack(body[: _MC_HEAD.size])
        if prev_codes is not None:
            prev_codes = _shift_codes(prev_codes, depth, mv)
        return _decode_temporal(
            body[_MC_HEAD.size :], depth, n_voxels, dtype, prev_codes, crc,
            backend, ext3=data[0] == _PROFILE_V5_TEMPORAL_MC_EXT,
            max_level=level,
        )
    if data[0] not in (_PROFILE_V0, _PROFILE_V3_INTRA_EXT):
        raise ValueError(f"unknown geometry coder profile {data[0]}")
    ext3 = data[0] == _PROFILE_V3_INTRA_EXT
    if _use_native(backend):
        lib = NATIVE.load()
        fn = lib.geom_decode_codes3_lod if ext3 else lib.geom_decode_codes_lod
        buf = np.ascontiguousarray(np.frombuffer(body, dtype=np.uint8))
        out = np.empty(n_voxels, dtype=np.uint64)
        out_n = ctypes.c_size_t()
        rc = fn(
            _u8ptr(buf), buf.size, depth, level,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), out.size,
            ctypes.byref(out_n),
        )
        if rc != 0:
            raise ValueError(
                f"geometry LOD decode failed (rc={rc}): corrupt stream or "
                "capacity overflow"
            )
        u = out[: out_n.value]
    else:
        fn = _geom_py.decode3_lod if ext3 else _geom_py.decode_codes_lod
        try:
            u = fn(body, depth, level, n_voxels)
        except MemoryError:
            raise ValueError(
                "corrupt geometry stream: decode exceeded plausible memory"
            )
    codes = u.astype(dtype)
    if np.dtype(dtype) != np.uint64 and np.any(codes.astype(np.uint64) != u):
        raise ValueError(f"decoded codes overflow dtype {np.dtype(dtype)}")
    return codes


def positions_from_geometry_lod(
    data: bytes, depth: int, n_voxels: int, level: int, *, device: DeviceLike = None
) -> np.ndarray:
    """LOD counterpart of :func:`positions_from_geometry`: ``(M, 3)`` int64
    positions on the 2^level coarse grid, Morton order."""
    codes = decode_geometry_lod(data, depth, n_voxels, level)
    return _positions(codes, level, device)


def _decode_temporal(
    payload: bytes, depth: int, n_voxels: int, dtype, prev_codes, crc,
    backend: str, ext3: bool = False, max_level: Optional[int] = None,
) -> np.ndarray:
    if prev_codes is None:
        raise ValueError(
            "temporal geometry section needs prev_codes (decode the "
            "sequence in order — each frame's geometry is predicted from "
            "the previous frame's)"
        )
    native = _use_native(backend)
    lv_prev, occ_prev = octree_levels(prev_codes, depth)
    if ext3:
        dec = (
            _NativeTemporalDecoder4(payload)
            if native
            else _geom_py.TemporalDecoder4(payload)
        )
    else:
        dec = (
            _NativeTemporalDecoder(payload)
            if native
            else _geom_py.TemporalDecoder(payload)
        )
    level_codes = np.zeros(1, dtype=np.uint64)
    occ_all = []
    n_levels = depth if max_level is None else max_level
    try:
        for l in range(n_levels):
            # each internal node has at least one descendant leaf, so a
            # level can never hold more nodes than the header voxel count
            if level_codes.size > n_voxels:
                raise ValueError(
                    "corrupt temporal geometry stream: level walk exceeds "
                    f"{n_voxels} voxels"
                )
            matched, pb = _match_level(level_codes, lv_prev[l], occ_prev[l])
            if ext3:
                n6 = level_neighbors6(level_codes, l)
                b = dec.decode_level(matched, pb, n6, level_codes.size, l)
            else:
                b = dec.decode_level(matched, pb, level_codes.size, l)
            occ_all.append(b)
            rows, cols = np.nonzero(_BITS8[b])
            level_codes = (level_codes[rows] << np.uint64(3)) | cols.astype(
                np.uint64
            )
    except MemoryError:
        raise ValueError(
            "corrupt geometry stream: decode exceeded plausible memory"
        )
    if max_level is not None:
        # partial (LOD) walk: the CRC covers the full occupancy stream and
        # the header count the leaf level — neither applies at a level cut,
        # but the per-level capacity bound still does (the loop checks it
        # only at the top of each iteration, so the final expansion at the
        # cut level needs its own check, like the intra LOD decoders).
        if level_codes.size > n_voxels:
            raise ValueError(
                "corrupt temporal geometry stream: level walk exceeds "
                f"{n_voxels} voxels"
            )
        assert dtype is not None  # decode_geometry_lod resolves the tier
        return level_codes.astype(dtype)
    if zlib.crc32(np.concatenate(occ_all).tobytes()) != crc:
        raise ValueError(
            "corrupt geometry stream: occupancy checksum mismatch "
            "(bad data or wrong temporal reference frame)"
        )
    if dtype is None:
        dtype = np.int32 if depth <= 10 else np.int64
    codes = level_codes.astype(dtype)
    if codes.size != n_voxels:
        raise ValueError(
            f"corrupt geometry stream: decoded {codes.size} voxels, "
            f"header says {n_voxels}"
        )
    return codes
