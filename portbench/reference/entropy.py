"""Plain RLGR coder and R3TC reader of the benchmark's reference.

The coder is a frozen copy of ``raht3dgs_tpu_torch/codec/_rlgr_py.py``
(the Malvar DCC'06 automaton the reference codec's ``membuf.cpp`` runs:
L=4, U0=3, D0=1, U1=2, D1=1, unary prefix capped at 32 with a 32-bit
escape, k_RP clamped to 32*L, MSB-first bits padded to a byte, and the
trailing partial-run flush). :func:`read_stream` parses the R3TC frame
container of ``raht3dgs_tpu_torch/codec/bitstream.py:152`` (``to_bytes``)
for the plain streams the benchmark's cells make: version 2, signed
symbols, RA-GFT order, mid-rise quantizer, RLGR channels, unchunked.
Anything else is refused. Imports nothing of the program.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Sequence

import numpy as np

FRAC, UP_NORUN, DOWN_NORUN, UP_RUN, DOWN_RUN = 4, 3, 1, 2, 1
ESCAPE = 32
MAX_KRP = 32 * FRAC


def _zigzag(v: int) -> int:
    return (-v << 1) - 1 if v < 0 else v << 1


def _unzigzag(u: int) -> int:
    half = u >> 1
    return -half - 1 if u & 1 else half


class _Sink:
    def __init__(self):
        self.bytes = bytearray()
        self.acc = 0
        self.count = 0

    def put(self, value: int, nbits: int) -> None:
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.count += nbits
        while self.count >= 8:
            self.count -= 8
            self.bytes.append((self.acc >> self.count) & 0xFF)
        self.acc &= (1 << self.count) - 1

    def finish(self) -> bytes:
        if self.count:
            self.put(0, 8 - self.count)
        return bytes(self.bytes)


class _Source:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.count = 0

    def get(self, nbits: int = 1) -> int:
        while self.count < nbits:
            byte = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.acc = (self.acc << 8) | byte
            self.count += 8
        self.count -= nbits
        v = (self.acc >> self.count) & ((1 << nbits) - 1)
        self.acc &= (1 << self.count) - 1
        return v


def _gr_put(sink: _Sink, u: int, k: int) -> None:
    q = u >> k
    if q < ESCAPE:
        sink.put(((1 << (q + 1)) - 1) - 1, q + 1)
        sink.put(u & ((1 << k) - 1), k)
    else:
        sink.put((1 << 32) - 1, 32)
        sink.put(u & 0xFFFFFFFF, 32)


def _gr_get(src: _Source, k: int) -> int:
    q = 0
    while src.get():
        q += 1
        if q >= ESCAPE:
            return src.get(32)
    return (q << k) + src.get(k)


def _adapt_krp(k_rp: int, u: int, k_r: int) -> int:
    q = u >> k_r
    if q:
        return min(k_rp + q - 1, MAX_KRP)
    return max(k_rp - 2, 0)


def encode(seq: Sequence[int]) -> bytes:
    """Signed RLGR bytes of ``seq``."""
    sink = _Sink()
    k_p, k_rp, run, k, u = 0, 2 * FRAC, 0, 0, 0
    for v in seq:
        u = _zigzag(int(v))
        k = k_p // FRAC
        k_r = k_rp // FRAC
        if k == 0:
            _gr_put(sink, u, k_r)
            k_rp = _adapt_krp(k_rp, u, k_r)
            k_p = max(k_p - DOWN_NORUN, 0) if u else k_p + UP_NORUN
            run = 0
        elif u == 0:
            run += 1
            if run == (1 << k):
                sink.put(1, 1)
                k_p += UP_RUN
                run = 0
        else:
            # membuf.cpp decrements u in place; the flush test below sees it
            u -= 1
            sink.put(0, 1)
            sink.put(run, k)
            _gr_put(sink, u, k_r)
            k_rp = _adapt_krp(k_rp, u, k_r)
            k_p = max(k_p - DOWN_RUN, 0)
            run = 0
    if k and u == 0:
        sink.put(0, 1)
        sink.put(run, k_p // FRAC)
    return sink.finish()


def decode(data: bytes, n: int) -> np.ndarray:
    """The first ``n`` signed symbols of RLGR ``data`` (int64)."""
    src = _Source(data)
    out: List[int] = []
    k_p, k_rp = 0, 2 * FRAC
    while len(out) < n:
        k = k_p // FRAC
        k_r = k_rp // FRAC
        if k:
            zeros = 0
            while src.get():
                zeros += 1 << k
                k_p += UP_RUN
                k = k_p // FRAC
            zeros += src.get(k) if k else 0
            take = min(zeros, n - len(out))
            out.extend([0] * take)
            if len(out) >= n:
                break
            u = _gr_get(src, k_r)
            out.append(_unzigzag(u + 1))
            k_rp = _adapt_krp(k_rp, u, k_r)
            k_p = max(k_p - DOWN_RUN, 0)
        else:
            u = _gr_get(src, k_r)
            out.append(_unzigzag(u))
            k_rp = _adapt_krp(k_rp, u, k_r)
            k_p = max(k_p - DOWN_NORUN, 0) if u else k_p + UP_NORUN
    return np.asarray(out, dtype=np.int64)


class Stream(NamedTuple):
    depth: int
    n_voxels: int
    steps: np.ndarray
    channels: List[bytes]


FLAG_SIGNED, FLAG_DTYPE32 = 1, 1 << 7


def read_stream(data: bytes) -> Stream:
    """Parse a plain R3TC v2 frame (see the module docstring)."""
    magic, version, flags, depth, nch, nvox, nsteps = struct.unpack_from("<4sBBBHQH", data)
    if magic != b"R3TC" or version != 2:
        raise ValueError(f"not a plain R3TC v2 frame ({magic!r}, v{version})")
    if flags & ~(FLAG_SIGNED | FLAG_DTYPE32) or not flags & FLAG_SIGNED:
        raise ValueError(f"unexpected R3TC flags {flags:#04x}")
    off = struct.calcsize("<4sBBBHQH")
    steps = np.frombuffer(data, "<f8", nsteps, off).copy()
    off += 8 * nsteps + 8 * 3 + 8  # steps, vmin, width
    lens = struct.unpack_from(f"<{nch}I", data, off)
    off += 4 * nch
    chans = []
    for n in lens:
        chans.append(data[off:off + n])
        off += n
    if off != len(data):
        raise ValueError(f"R3TC frame of {len(data)} bytes, {off} parsed")
    return Stream(depth, nvox, steps, chans)


def write_stream(q: np.ndarray, steps, depth: int) -> bytes:
    """A plain R3TC v2 frame of the ``(D, n)`` symbols ``q``: the layout
    :func:`read_stream` reads (vmin 0, width ``2**depth``)."""
    D, n = q.shape
    st = np.atleast_1d(np.asarray(steps, np.float64))
    chans = [encode(row) for row in q]
    head = struct.pack("<4sBBBHQH", b"R3TC", 2, FLAG_SIGNED | FLAG_DTYPE32, depth, D, n,
                       st.shape[0])
    head += st.astype("<f8").tobytes() + np.zeros(3, "<f8").tobytes()
    head += struct.pack("<d", float(1 << depth)) + struct.pack(f"<{D}I", *map(len, chans))
    return head + b"".join(chans)
