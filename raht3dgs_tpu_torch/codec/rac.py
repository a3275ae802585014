"""RAC entropy coding through the native C++ coder.

Counterpart of ``raht3dgs_tpu/codec/rac.py``: adaptive binary range coding
of the quantized symbols (sig/sign/gt1/gt2/Rice-remainder binarization
over the automaton of ``native/range_coder.h``), the attribute coder that
the ``rac`` and ``auto`` entropy choices select. The coder is the port's
own byte-identical copy of ``native/rac.cpp`` (the stream format is
frozen), built with g++ into ``_build/``; a failed build raises. The
plain twin ``codec/_rac_py.py`` runs only when a caller names it
(``backend="python"``).

The API mirrors ``codec/rlgr.py``: single streams, the chunked layout
(the same ``u32 chunk | u32 n_chunks | u32 len[i]...`` framing, imported
from ``rlgr.py``), per-channel entry points and a one-call native batch
path for whole (D, N) int32 matrices (``batch=False`` codes stream by
stream, with the same bytes).

The Rice-parameter position buckets depend on the stream's total symbol
count, so prefix decodes (progressive) pass both ``n`` (symbols wanted)
and ``n_total`` (symbols encoded). For chunked streams bucketing is
chunk-local.
"""

from __future__ import annotations

import ctypes
import os
import time
from typing import List, Optional, Tuple

import numpy as np

from raht3dgs_tpu_torch.codec import _rac_py
from raht3dgs_tpu_torch.codec._native import NativeLib, gxx_command
from raht3dgs_tpu_torch.codec.rlgr import (
    _map_tasks,
    _pack_chunk_header,
    _parse_chunk_header,
)

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)

_pu8 = ctypes.POINTER(ctypes.c_uint8)
_pi32 = ctypes.POINTER(ctypes.c_int32)
_psz = ctypes.POINTER(ctypes.c_size_t)
BACKENDS = ("native", "python")


def _configure(lib: ctypes.CDLL) -> None:
    lib.rac_encode.argtypes = [_pi32, ctypes.c_size_t, ctypes.POINTER(_pu8), _psz]
    lib.rac_encode.restype = ctypes.c_int
    lib.rac_decode.argtypes = [_pu8, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
                               _pi32]
    lib.rac_decode.restype = ctypes.c_int
    lib.rac_encode_cond.argtypes = [_pi32, _pu8, ctypes.c_size_t, ctypes.POINTER(_pu8),
                                    _psz]
    lib.rac_encode_cond.restype = ctypes.c_int
    lib.rac_decode_cond.argtypes = [_pu8, ctypes.c_size_t, ctypes.c_size_t,
                                    ctypes.c_size_t, _pu8, _pi32]
    lib.rac_decode_cond.restype = ctypes.c_int
    lib.rac_buffer_free.argtypes = [_pu8]
    lib.rac_buffer_free.restype = None
    lib.rac_encode_batch.argtypes = [_pi32, _psz, _psz, ctypes.c_size_t, ctypes.c_int,
                                     ctypes.POINTER(_pu8), _psz]
    lib.rac_encode_batch.restype = ctypes.c_int
    lib.rac_decode_batch.argtypes = [_pu8, _psz, _psz, _psz, _psz, _psz, ctypes.c_size_t,
                                     ctypes.c_int, _pi32]
    lib.rac_decode_batch.restype = ctypes.c_int


NATIVE = NativeLib(os.path.join(_NATIVE_DIR, "rac.cpp"), "librac.so", _configure,
                   lambda src, out: gxx_command(src, out, ("-pthread",)),
                   deps=(os.path.join(_NATIVE_DIR, "range_coder.h"),))


def _library(backend: str) -> Optional[ctypes.CDLL]:
    """The loaded library for ``backend="native"``, None for the twin."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown RAC backend {backend!r} (choose from {BACKENDS})")
    return NATIVE.load() if backend == "native" else None


def _sz_array(values) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(values, dtype=np.uintp))


def _sz_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_psz)


def _cond_bits(cond, n: int) -> np.ndarray:
    bits = np.ascontiguousarray(np.asarray(cond) != 0, dtype=np.uint8).ravel()
    if len(bits) < n:
        raise ValueError(f"cond has {len(bits)} entries for {n} symbols")
    return bits


def rac_encode(values: np.ndarray, backend: str = "native",
               cond: Optional[np.ndarray] = None) -> Tuple[bytes, int]:
    """Encode int32 symbols; returns ``(stream, elapsed_ns)``.

    ``cond`` (nonzero = set, one entry a symbol) selects profile 1: every
    adaptive decision doubles its context on ``cond[i]`` (by convention
    the co-located decoded channel-0 significance). The profile byte
    leads the stream."""
    seq = np.ascontiguousarray(values, dtype=np.int32).ravel()
    if cond is not None:
        cond = _cond_bits(cond, len(seq))
    lib = _library(backend)
    t0 = time.perf_counter_ns()
    if lib is None:
        return _rac_py.rac_encode_py(seq, cond=cond), time.perf_counter_ns() - t0
    out = _pu8()
    out_len = ctypes.c_size_t()
    if cond is not None:
        rc = lib.rac_encode_cond(seq.ctypes.data_as(_pi32), cond.ctypes.data_as(_pu8),
                                 len(seq), ctypes.byref(out), ctypes.byref(out_len))
    else:
        rc = lib.rac_encode(seq.ctypes.data_as(_pi32), len(seq), ctypes.byref(out),
                            ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"rac_encode failed (rc={rc})")
    data = ctypes.string_at(out, out_len.value)
    lib.rac_buffer_free(out)
    return data, time.perf_counter_ns() - t0


def rac_decode(stream: bytes, n: int, n_total: Optional[int] = None,
               backend: str = "native", out: Optional[np.ndarray] = None,
               cond: Optional[np.ndarray] = None) -> Tuple[np.ndarray, int]:
    """Decode the first ``n`` of ``n_total`` symbols (``n_total`` defaults
    to ``n``, a full decode); returns ``(int32 array, elapsed_ns)``.
    ``cond`` must be given iff the stream is profile 1 (its first ``n``
    entries are read). A corrupt or truncated stream raises ValueError."""
    n_total = n if n_total is None else n_total
    if n > n_total:
        raise ValueError(f"n {n} > n_total {n_total}")
    if cond is not None:
        cond = _cond_bits(cond, n)
    lib = _library(backend)
    if out is None:
        out = np.empty(n, dtype=np.int32)
    if out.dtype != np.int32 or not out.flags.c_contiguous or len(out) < n:
        raise ValueError("decode target must be contiguous int32 and hold n symbols")
    t0 = time.perf_counter_ns()
    if lib is None:
        _rac_py.rac_decode_py(stream, n, n_total, out=out, cond=cond)
        return out, time.perf_counter_ns() - t0
    buf = ctypes.cast(ctypes.c_char_p(stream), _pu8)
    if cond is not None:
        rc = lib.rac_decode_cond(buf, len(stream), n, n_total, cond.ctypes.data_as(_pu8),
                                 out.ctypes.data_as(_pi32))
    else:
        rc = lib.rac_decode(buf, len(stream), n, n_total, out.ctypes.data_as(_pi32))
    if rc != 0:
        raise ValueError(f"bad RAC stream (rc={rc})")
    return out, time.perf_counter_ns() - t0


# -- chunked layout (the framing of codec/rlgr.py) ------------------------------


def rac_encode_chunked(values: np.ndarray, chunk: int = 65536,
                       cond: Optional[np.ndarray] = None,
                       backend: str = "native") -> Tuple[bytes, int]:
    """Self-contained fixed-size chunks, framed as
    :func:`codec.rlgr.rlgr_encode_chunked` frames them. Bucketing (and
    profile-1 conditioning, when ``cond`` is given) is chunk-local."""
    values = np.ascontiguousarray(values, dtype=np.int32)
    n = len(values)
    chunk = max(int(chunk), 1)
    n_chunks = max((n + chunk - 1) // chunk, 1)
    parts = [(values[i * chunk:(i + 1) * chunk],
              None if cond is None else cond[i * chunk:(i + 1) * chunk])
             for i in range(n_chunks)]
    t0 = time.perf_counter_ns()
    results = _map_tasks(lambda p: rac_encode(p[0], backend, cond=p[1])[0], parts)
    elapsed = time.perf_counter_ns() - t0
    return _pack_chunk_header(chunk, [len(r) for r in results]) + b"".join(results), elapsed


def rac_decode_chunked(stream: bytes, n: int, n_total: Optional[int] = None,
                       out: Optional[np.ndarray] = None,
                       cond: Optional[np.ndarray] = None,
                       backend: str = "native") -> Tuple[np.ndarray, int]:
    """Decode a :func:`rac_encode_chunked` stream's first ``n`` symbols.

    ``n_total`` is the symbol count the encoder saw (default ``n``). It
    matters only when a prefix decode ends inside the encoder's final
    (short) chunk: that chunk's Rice-bucket table derives from its true
    encoded length ``n_total - i*chunk``, not from ``chunk``."""
    n_total = n if n_total is None else n_total
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
            enc_m = min(chunk, max(n_total - i * chunk, m))
            rac_decode(stream[offs[i]:offs[i + 1]], m, enc_m, backend,
                       out=out[i * chunk:][:m],
                       cond=None if cond is None else cond[i * chunk:i * chunk + m])

    _map_tasks(_one, list(range((n + chunk - 1) // chunk)))
    return out, time.perf_counter_ns() - t0


def rac_stream_profile(payload: bytes, chunk: int = 0) -> int:
    """The leading profile byte of a (possibly chunked) RAC channel payload;
    -1 when it cannot be read. Profile 1 streams need channel-0
    conditioning at decode."""
    try:
        if chunk > 0:
            _, _, off = _parse_chunk_header(payload)
            return payload[off] if len(payload) > off else -1
        return payload[0] if payload else -1
    except ValueError:
        return -1


# -- per-channel entry points (the codec's entropy stage) -----------------------


def _batchable(arr, batch: bool) -> bool:
    return (batch and isinstance(arr, np.ndarray) and arr.ndim == 2
            and arr.dtype == np.int32 and arr.flags.c_contiguous)


def _encode_batch(flat: np.ndarray, offsets, ns) -> List[bytes]:
    """Encode independent int32 jobs through ONE native call (C++ threads);
    job j covers ``flat[offsets[j]:offsets[j]+ns[j]]``."""
    lib = NATIVE.load()
    count = len(ns)
    offs, nss = _sz_array(offsets), _sz_array(ns)
    outs = (_pu8 * count)()
    lens = np.zeros(count, dtype=np.uintp)
    rc = lib.rac_encode_batch(flat.ctypes.data_as(_pi32), _sz_ptr(offs), _sz_ptr(nss),
                              count, 0, outs, _sz_ptr(lens))
    if rc != 0:
        raise RuntimeError(f"rac_encode_batch failed (rc={rc})")
    streams = []
    for j in range(count):
        streams.append(ctypes.string_at(outs[j], int(lens[j])))
        lib.rac_buffer_free(outs[j])
    return streams


def rac_encode_channels(payload: np.ndarray, channel_major: bool = False,
                        chunk: int = 0, n: Optional[int] = None,
                        batch: bool = True) -> Tuple[List[bytes], int]:
    """Encode each channel of a payload as its own RAC stream, with the
    layout contract of :func:`codec.rlgr.rlgr_encode_channels` (``n``
    limits each channel to its first n symbols without slicing). An int32
    C-contiguous channel matrix goes through one native batch call unless
    ``batch=False``."""
    payload = np.asarray(payload)
    rows = payload if channel_major else np.ascontiguousarray(payload.T)
    D, row_len = rows.shape
    n = row_len if n is None else min(int(n), row_len)
    t0 = time.perf_counter_ns()
    if _batchable(rows, batch):
        flat = rows.reshape(-1)
        if chunk > 0:
            c = max(int(chunk), 1)
            n_chunks = max((n + c - 1) // c, 1)
            offsets, ns = [], []
            for d in range(D):
                for i in range(n_chunks):
                    offsets.append(d * row_len + i * c)
                    ns.append(min(c, n - i * c) if n > i * c else 0)
            parts = _encode_batch(flat, offsets, ns)
            streams = []
            for d in range(D):
                mine = parts[d * n_chunks:(d + 1) * n_chunks]
                streams.append(_pack_chunk_header(c, [len(p) for p in mine])
                               + b"".join(mine))
        else:
            streams = _encode_batch(flat, [d * row_len for d in range(D)], [n] * D)
        return streams, time.perf_counter_ns() - t0
    rows32 = np.ascontiguousarray(rows[:, :n], dtype=np.int32)
    if chunk > 0:
        streams = [rac_encode_chunked(rows32[d], chunk)[0] for d in range(D)]
    else:
        streams = [rac_encode(rows32[d])[0] for d in range(D)]
    return streams, time.perf_counter_ns() - t0


def rac_decode_channels(channels: List[bytes], n: int, out: np.ndarray, chunk: int = 0,
                        n_total: Optional[int] = None,
                        batch: bool = True) -> Tuple[np.ndarray, int]:
    """Decode per-channel RAC streams' first ``n`` symbols into the rows of
    ``out`` (a (D, >=n) int32 matrix). ``n_total`` is the per-channel
    symbol count the encoder saw (default ``n``; required for prefix
    decodes of unchunked streams)."""
    D = len(channels)
    if out.shape[0] < D or out.dtype != np.int32:
        raise ValueError("decode target must be a (D, >=n) int32 matrix")
    n_total = n if n_total is None else n_total
    t0 = time.perf_counter_ns()
    if chunk > 0:
        for d in range(D):
            rac_decode_chunked(channels[d], n, n_total, out=out[d, :n])
        return out, time.perf_counter_ns() - t0
    if _batchable(out, batch) and D > 1:
        lib = NATIVE.load()
        buf = b"".join(channels)
        lens = [len(c) for c in channels]
        boffs = np.concatenate([[0], np.cumsum(lens)])[:-1]
        row_len = out.shape[1]
        rc = lib.rac_decode_batch(
            ctypes.cast(ctypes.c_char_p(buf), _pu8), _sz_ptr(_sz_array(boffs)),
            _sz_ptr(_sz_array(lens)), _sz_ptr(_sz_array([n] * D)),
            _sz_ptr(_sz_array([n_total] * D)),
            _sz_ptr(_sz_array([d * row_len for d in range(D)])), D, 0,
            out.ctypes.data_as(_pi32),
        )
        if rc != 0:
            raise ValueError(f"bad RAC stream (rc={rc})")
        return out, time.perf_counter_ns() - t0
    for d in range(D):
        rac_decode(channels[d], n, n_total, out=out[d, :n])
    return out, time.perf_counter_ns() - t0
