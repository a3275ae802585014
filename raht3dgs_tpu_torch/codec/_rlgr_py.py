"""Pure-Python RLGR coder: the plain reference for the native backend.

A copy of ``raht3dgs_tpu/codec/_rlgr_py.py``, bit-identical to
``native/rlgr.cpp`` (the Malvar DCC'06 automaton): L=4, U0=3, D0=1, U1=2,
D1=1, unary prefix capped at 32 with a 32-bit escape, k_RP clamped to 32*L,
MSB-first bit packing with zero padding to a byte boundary, and the
trailing partial-run flush.

The port's tests hold the native library against it byte for byte; unlike
the JAX package, the port never falls back to it when the native build
fails.
"""

from __future__ import annotations

from typing import List, Sequence

FRAC = 4          # L
UP_NORUN = 3      # U0
DOWN_NORUN = 1    # D0
UP_RUN = 2        # U1
DOWN_RUN = 1      # D1
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

    def put_unary(self, ones: int) -> None:
        self.put(((1 << (ones + 1)) - 1) - 1, ones + 1)

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
        sink.put_unary(q)
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


def encode(seq: Sequence[int], signed: bool = True) -> bytes:
    sink = _Sink()
    k_p = 0
    k_rp = 2 * FRAC
    run = 0
    k = 0
    u = 0
    for v in seq:
        u = _zigzag(int(v)) if signed else int(v)
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
            # The reference decrements u in place (membuf.cpp `u--`), which
            # aliases the trailing-flush test below: a final run-terminating
            # symbol whose mapped value is exactly 1 leaves u == 0 and
            # triggers a (spurious but byte-contractual) flush.
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


def decode(data: bytes, n: int, signed: bool = True) -> List[int]:
    src = _Source(data)
    out: List[int] = []
    k_p = 0
    k_rp = 2 * FRAC
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
            out.append(_unzigzag(u + 1) if signed else u + 1)
            k_rp = _adapt_krp(k_rp, u, k_r)
            k_p = max(k_p - DOWN_RUN, 0)
        else:
            u = _gr_get(src, k_r)
            out.append(_unzigzag(u) if signed else u)
            k_rp = _adapt_krp(k_rp, u, k_r)
            k_p = max(k_p - DOWN_NORUN, 0) if u else k_p + UP_NORUN
    return out
