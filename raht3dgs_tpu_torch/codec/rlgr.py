"""RLGR entropy coding through the native C++ coder.

Counterpart of ``raht3dgs_tpu/codec/rlgr.py``. The coder is the port's own
byte-identical copy of ``native/rlgr.cpp`` (the stream format is frozen),
built with g++ into ``_build/`` and called through ctypes on contiguous
numpy buffers. A failed build raises; ``codec/_rlgr_py.py`` is the plain
reference the tests hold the library against.

Layouts: sequential streams (one adaptive automaton per channel) and the
chunked layout ``u32 chunk | u32 n_chunks | u32 len[i]... | payloads`` of
self-contained chunks. An int32 C-contiguous (D, N) channel matrix goes
through one native batch call (C++ thread pool); other inputs are coded
stream by stream, with the same bytes.
"""

from __future__ import annotations

import ctypes
import os
import struct
import time
from typing import List, Optional, Tuple

import numpy as np

from raht3dgs_tpu_torch.codec._native import NativeLib, gxx_command

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native", "rlgr.cpp",
)


def _configure(lib: ctypes.CDLL) -> None:
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    psz = ctypes.POINTER(ctypes.c_size_t)
    lib.rlgr_encode.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(pu8), psz,
    ]
    lib.rlgr_encode.restype = ctypes.c_int
    lib.rlgr_decode.argtypes = [
        pu8, ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_size_t,
    ]
    lib.rlgr_decode.restype = ctypes.c_int
    lib.rlgr_buffer_free.argtypes = [pu8]
    lib.rlgr_buffer_free.restype = None
    lib.rlgr_encode32.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(pu8), psz,
    ]
    lib.rlgr_encode32.restype = ctypes.c_int
    lib.rlgr_decode32.argtypes = [
        pu8, ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t,
    ]
    lib.rlgr_decode32.restype = ctypes.c_int
    lib.rlgr_encode_batch32.argtypes = [
        ctypes.POINTER(ctypes.c_int32), psz, psz, ctypes.c_size_t,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(pu8), psz,
    ]
    lib.rlgr_encode_batch32.restype = ctypes.c_int
    lib.rlgr_decode_batch32.argtypes = [
        pu8, psz, psz, psz, psz, ctypes.c_size_t, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.rlgr_decode_batch32.restype = ctypes.c_int


NATIVE = NativeLib(_SRC, "librlgr.so", _configure,
                   lambda src, out: gxx_command(src, out, ("-pthread",)))


def _sz_array(values) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(values, dtype=np.uintp))


def _sz_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t))


def _as_u8(stream: bytes):
    return ctypes.cast(ctypes.c_char_p(stream), ctypes.POINTER(ctypes.c_uint8))


def _encode_batch32(flat: np.ndarray, offsets, ns, signed: bool,
                    threads: int = 0) -> List[bytes]:
    """Encode independent int32 jobs through ONE native call; job j covers
    ``flat[offsets[j]:offsets[j]+ns[j]]``."""
    if flat.dtype != np.int32 or not flat.flags.c_contiguous:
        raise ValueError("batch encode takes a contiguous int32 buffer")
    lib = NATIVE.load()
    count = len(ns)
    offs = _sz_array(offsets)
    nss = _sz_array(ns)
    outs = (ctypes.POINTER(ctypes.c_uint8) * count)()
    lens = np.zeros(count, dtype=np.uintp)
    rc = lib.rlgr_encode_batch32(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _sz_ptr(offs), _sz_ptr(nss), count, int(signed), int(threads),
        outs, _sz_ptr(lens),
    )
    if rc != 0:
        raise RuntimeError(f"rlgr_encode_batch32 failed (rc={rc})")
    streams = []
    for j in range(count):
        streams.append(ctypes.string_at(outs[j], int(lens[j])))
        lib.rlgr_buffer_free(outs[j])
    return streams


def _decode_batch32(buf: bytes, buf_offsets, buf_lens, ns, out_offsets,
                    out_flat: np.ndarray, signed: bool, threads: int = 0) -> None:
    """Decode independent jobs from one concatenated stream buffer into a
    shared int32 output buffer through ONE native call."""
    if out_flat.dtype != np.int32 or not out_flat.flags.c_contiguous:
        raise ValueError("batch decode writes a contiguous int32 buffer")
    lib = NATIVE.load()
    boffs = _sz_array(buf_offsets)
    blens = _sz_array(buf_lens)
    nss = _sz_array(ns)
    ooffs = _sz_array(out_offsets)
    rc = lib.rlgr_decode_batch32(
        _as_u8(buf), _sz_ptr(boffs), _sz_ptr(blens), _sz_ptr(nss),
        _sz_ptr(ooffs), len(ns), int(signed), int(threads),
        out_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"rlgr_decode_batch32 failed (rc={rc})")


def rlgr_encode(values: np.ndarray, signed: bool = True) -> Tuple[bytes, int]:
    """Encode an integer array; returns ``(stream, elapsed_ns)``."""
    values = np.asarray(values)
    lib = NATIVE.load()
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    t0 = time.perf_counter_ns()
    if values.dtype == np.int32 and values.ndim == 1 and values.flags.c_contiguous:
        rc = lib.rlgr_encode32(
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(values), int(signed), ctypes.byref(out), ctypes.byref(out_len),
        )
    else:
        seq = np.ascontiguousarray(values, dtype=np.int64).ravel()
        rc = lib.rlgr_encode(
            seq.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(seq), int(signed), ctypes.byref(out), ctypes.byref(out_len),
        )
    if rc != 0:
        raise RuntimeError(f"rlgr_encode failed (rc={rc})")
    data = ctypes.string_at(out, out_len.value)
    lib.rlgr_buffer_free(out)
    return data, time.perf_counter_ns() - t0


def rlgr_decode(stream: bytes, n: int, signed: bool = True,
                out: Optional[np.ndarray] = None) -> Tuple[np.ndarray, int]:
    """Decode ``n`` symbols into ``out`` (contiguous int32/int64, allocated
    as int64 when absent); returns ``(array, elapsed_ns)``."""
    if out is None:
        out = np.empty(n, dtype=np.int64)
    if not out.flags.c_contiguous or len(out) < n:
        raise ValueError("decode target must be contiguous and hold n symbols")
    lib = NATIVE.load()
    t0 = time.perf_counter_ns()
    if out.dtype == np.int32:
        rc = lib.rlgr_decode32(_as_u8(stream), len(stream), int(signed),
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
    elif out.dtype == np.int64:
        rc = lib.rlgr_decode(_as_u8(stream), len(stream), int(signed),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n)
    else:
        raise TypeError(f"decode target must be int32 or int64, got {out.dtype}")
    if rc != 0:
        raise RuntimeError(f"rlgr_decode failed (rc={rc})")
    return out, time.perf_counter_ns() - t0


_pool = None


def _map_tasks(fn, tasks):
    """Run ``fn`` over ``tasks`` on a shared thread pool when that can help
    (ctypes releases the GIL inside the native coders, so chunks and
    channels code in parallel), else serially; results in task order."""
    global _pool
    if len(tasks) > 1 and (os.cpu_count() or 1) > 1:
        if _pool is None:
            from concurrent.futures import ThreadPoolExecutor

            _pool = ThreadPoolExecutor(max_workers=min(32, os.cpu_count() or 1))
        return list(_pool.map(fn, tasks))
    return [fn(t) for t in tasks]


def _pack_chunk_header(chunk: int, lens) -> bytes:
    """Chunked framing ``u32 chunk | u32 n_chunks | u32 len[i]...``: the one
    definition the per-stream and batch encoders share."""
    return struct.pack(f"<II{len(lens)}I", chunk, len(lens), *lens)


def _parse_chunk_header(stream: bytes):
    """Parse and validate chunked framing; returns (chunk, lens, payload_off).
    Raises ValueError on any truncation, including a length table whose
    payloads would run past the buffer."""
    if len(stream) < 8:
        raise ValueError(
            f"truncated chunked stream: {len(stream)} bytes, header needs 8"
        )
    chunk, n_chunks = struct.unpack_from("<II", stream, 0)
    if len(stream) < 8 + 4 * n_chunks:
        raise ValueError("truncated chunked stream: length table cut off")
    lens = struct.unpack_from(f"<{n_chunks}I", stream, 8)
    payload_off = 8 + 4 * n_chunks
    if payload_off + sum(lens) > len(stream):
        raise ValueError(
            "truncated chunked stream: payloads exceed the buffer "
            f"({payload_off + sum(lens)} > {len(stream)} bytes)"
        )
    return chunk, lens, payload_off


def rlgr_encode_chunked(values: np.ndarray, signed: bool = True,
                        chunk: int = 65536) -> Tuple[bytes, int]:
    """Encode as independent fixed-size chunks (the automaton resets at
    every chunk boundary, so chunks decode independently)."""
    values = np.asarray(values)
    n = len(values)
    chunk = max(int(chunk), 1)
    n_chunks = max((n + chunk - 1) // chunk, 1)
    t0 = time.perf_counter_ns()
    parts = _map_tasks(lambda i: rlgr_encode(values[i * chunk:(i + 1) * chunk], signed)[0],
                       list(range(n_chunks)))
    elapsed = time.perf_counter_ns() - t0
    return _pack_chunk_header(chunk, [len(p) for p in parts]) + b"".join(parts), elapsed


def rlgr_decode_chunked(stream: bytes, n: int, signed: bool = True,
                        out: Optional[np.ndarray] = None) -> Tuple[np.ndarray, int]:
    """Decode a :func:`rlgr_encode_chunked` stream."""
    chunk, lens, payload_off = _parse_chunk_header(stream)
    n_chunks = len(lens)
    if n_chunks * chunk < n:
        raise ValueError(
            f"truncated chunked stream: {n_chunks} chunks of {chunk} cover "
            f"{n_chunks * chunk} symbols, need {n}"
        )
    offs = np.concatenate([[payload_off], payload_off + np.cumsum(lens)])
    if out is None:
        out = np.empty(n, dtype=np.int32)
    t0 = time.perf_counter_ns()

    def _one(i):
        m = min(chunk, n - i * chunk)
        if m > 0:
            rlgr_decode(stream[offs[i]:offs[i + 1]], m, signed, out=out[i * chunk:])

    _map_tasks(_one, list(range(n_chunks)))
    return out, time.perf_counter_ns() - t0


def _batchable(arr) -> bool:
    return (isinstance(arr, np.ndarray) and arr.dtype == np.int32
            and arr.ndim == 2 and arr.flags.c_contiguous)


def rlgr_encode_channels(payload: np.ndarray, signed: bool = True,
                         channel_major: bool = False, chunk: int = 0,
                         n: Optional[int] = None) -> Tuple[List[bytes], int]:
    """Encode each channel of a payload as its own RLGR stream.

    ``payload`` is (N, D) sample-major, or (D, N) with ``channel_major``.
    ``n`` limits each channel to its first n symbols without slicing, so
    the int32 (D, N) matrix stays eligible for the one-call batch path.
    ``chunk > 0`` selects the chunked layout. Returns (streams, coder ns).
    """
    payload = np.asarray(payload)
    rows = payload if channel_major else np.ascontiguousarray(payload.T)
    D, row_len = rows.shape
    n = row_len if n is None else min(int(n), row_len)
    t0 = time.perf_counter_ns()
    if _batchable(rows):
        flat = rows.reshape(-1)
        if chunk > 0:
            c = max(int(chunk), 1)
            n_chunks = max((n + c - 1) // c, 1)
            offsets, ns = [], []
            for d in range(D):
                for i in range(n_chunks):
                    offsets.append(d * row_len + i * c)
                    ns.append(max(min(c, n - i * c), 0))
            parts = _encode_batch32(flat, offsets, ns, signed)
            streams = []
            for d in range(D):
                mine = parts[d * n_chunks:(d + 1) * n_chunks]
                streams.append(_pack_chunk_header(c, [len(p) for p in mine])
                               + b"".join(mine))
        else:
            streams = _encode_batch32(flat, [d * row_len for d in range(D)],
                                      [n] * D, signed)
        return streams, time.perf_counter_ns() - t0
    if chunk > 0:
        streams = [rlgr_encode_chunked(np.ascontiguousarray(rows[d][:n]),
                                       signed, chunk)[0] for d in range(D)]
    else:
        streams = [rlgr_encode(np.ascontiguousarray(rows[d][:n]), signed)[0]
                   for d in range(D)]
    return streams, time.perf_counter_ns() - t0


def rlgr_decode_channels(streams: List[bytes], n: int, signed: bool = True,
                         out: Optional[np.ndarray] = None,
                         chunk: int = 0) -> Tuple[np.ndarray, int]:
    """Decode per-channel streams into a (D, >=n) channel-major matrix.
    ``chunk`` must match the encoder's (0 = sequential)."""
    D = len(streams)
    if out is None:
        out = np.empty((D, n), dtype=np.int32)
    t0 = time.perf_counter_ns()
    if _batchable(out):
        stride = out.shape[1]
        buf = b"".join(streams)
        base = 0
        boffs, blens, ns, ooffs = [], [], [], []
        for d, s in enumerate(streams):
            if chunk > 0:
                c, lens, off = _parse_chunk_header(s)
                n_chunks = len(lens)
                if n_chunks * c < n:
                    raise ValueError(
                        f"truncated chunked stream (channel {d}): "
                        f"{n_chunks} chunks of {c} cover {n_chunks * c} "
                        f"symbols, need {n}"
                    )
                for i in range(n_chunks):
                    m = max(min(c, n - i * c), 0)
                    if m > 0:
                        boffs.append(base + off)
                        blens.append(lens[i])
                        ns.append(m)
                        ooffs.append(d * stride + i * c)
                    off += lens[i]
            else:
                boffs.append(base)
                blens.append(len(s))
                ns.append(n)
                ooffs.append(d * stride)
            base += len(s)
        _decode_batch32(buf, boffs, blens, ns, ooffs, out.reshape(-1), signed)
        return out, time.perf_counter_ns() - t0
    for d in range(D):
        if chunk > 0:
            rlgr_decode_chunked(streams[d], n, signed, out=out[d])
        else:
            rlgr_decode(streams[d], n, signed, out=out[d])
    return out, time.perf_counter_ns() - t0
