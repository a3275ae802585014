"""Plain Python attribute RAC coder, a bit-exact mirror of native/rac.cpp.

Counterpart of ``raht3dgs_tpu/codec/_rac_py.py``. The port codes through
the native library (``codec/rac.py``); this twin runs only when a caller
names it (``backend="python"``), and the tests hold the library's bytes
against it. The automaton (the carry-less binary range coder of
``native/range_coder.h``: 12-bit probabilities, shift-5 adaptation, plus
direct bypass bits) and the symbol layout (profile byte, packed Rice-k
table, sig/sign/gt1/gt2/Rice-remainder binarization, position-bucketed k)
are a frozen stream format.
"""

from __future__ import annotations

import numpy as np

_PROB_BITS = 12
_PROB_INIT = 1 << (_PROB_BITS - 1)
_ADAPT_SHIFT = 5
_TOP = 1 << 24
_MASK32 = 0xFFFFFFFF

_NUM_CTX = 3       # sig, gt1, gt2 (profile 0)
_NUM_CTX_COND = 6  # {sig, gt1, gt2} x cond bit (profile 1)
_BUCKETS = 8
_MAX_K = 15
_ESCAPE_Q = 20
_PROFILE = 0
_PROFILE_COND = 1


def _top_of(n: int) -> int:
    t = (n - 1).bit_length() if n > 1 else 0
    return t if t else 1


def _bucket_of(i: int, top: int) -> int:
    lg = (i + 1).bit_length() - 1
    b = lg * 8 // top
    return b if b < _BUCKETS - 1 else _BUCKETS - 1


def _rice_cost(rem: int, k: int) -> int:
    q = rem >> k
    return _ESCAPE_Q + 32 if q >= _ESCAPE_Q else q + 1 + k


class _Encoder:
    """Range encoder + direct bits (mirror of raht_rc::RangeEncoder)."""

    def __init__(self):
        self.out = bytearray()
        self._low = 0
        self._rng = _MASK32
        self._cache = 0
        self._cache_size = 1
        self.probs = [_PROB_INIT] * _NUM_CTX_COND

    def _shift_low(self):
        low = self._low
        if (low & _MASK32) < 0xFF000000 or (low >> 32) != 0:
            carry = low >> 32
            self.out.append((self._cache + carry) & 0xFF)
            for _ in range(self._cache_size - 1):
                self.out.append((0xFF + carry) & 0xFF)
            self._cache_size = 0
            self._cache = (low >> 24) & 0xFF
        self._cache_size += 1
        self._low = (low & 0x00FFFFFF) << 8

    def encode_bit(self, ci: int, bit: int):
        p = self.probs[ci]
        bound = (self._rng >> _PROB_BITS) * p
        if bit == 0:
            self._rng = bound
            self.probs[ci] = p + (((1 << _PROB_BITS) - p) >> _ADAPT_SHIFT)
        else:
            self._low += bound
            self._rng -= bound
            self.probs[ci] = p - (p >> _ADAPT_SHIFT)
        while self._rng < _TOP:
            self._shift_low()
            self._rng = (self._rng << 8) & _MASK32

    def encode_direct(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self._rng >>= 1
            if (value >> i) & 1:
                self._low += self._rng
            while self._rng < _TOP:
                self._shift_low()
                self._rng = (self._rng << 8) & _MASK32

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class _Decoder:
    """Mirror of raht_rc::RangeDecoder + direct bits."""

    def __init__(self, buf: bytes):
        self._buf = buf
        self._blen = len(buf)
        self._bpos = 1  # skip the initial cache byte (always 0)
        self._rng = _MASK32
        self.probs = [_PROB_INIT] * _NUM_CTX_COND
        code = 0
        for _ in range(4):
            code = (code << 8) | (
                buf[self._bpos] if self._bpos < self._blen else 0
            )
            self._bpos += 1
        self._code = code

    def decode_bit(self, ci: int) -> int:
        p = self.probs[ci]
        bound = (self._rng >> _PROB_BITS) * p
        if self._code < bound:
            bit = 0
            self._rng = bound
            self.probs[ci] = p + (((1 << _PROB_BITS) - p) >> _ADAPT_SHIFT)
        else:
            bit = 1
            self._code -= bound
            self._rng -= bound
            self.probs[ci] = p - (p >> _ADAPT_SHIFT)
        while self._rng < _TOP:
            # C++ code_ is uint32: the high byte drops on shift
            self._code = ((self._code << 8) | (
                self._buf[self._bpos] if self._bpos < self._blen else 0
            )) & _MASK32
            self._bpos += 1
            self._rng = (self._rng << 8) & _MASK32
        return bit

    def decode_direct(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            self._rng >>= 1
            bit = 1 if self._code >= self._rng else 0
            if bit:
                self._code -= self._rng
            v = (v << 1) | bit
            while self._rng < _TOP:
                # C++ code_ is uint32: the high byte drops on shift
                self._code = ((self._code << 8) | (
                    self._buf[self._bpos] if self._bpos < self._blen else 0
                )) & _MASK32
                self._bpos += 1
                self._rng = (self._rng << 8) & _MASK32
        return v


def rac_encode_py(q: np.ndarray, cond: np.ndarray = None) -> bytes:
    """Encode int32 symbols; byte-identical to native rac_encode.
    ``cond`` (uint8, len n) selects profile 1: every adaptive decision
    doubles its context on cond[i] != 0."""
    q = np.ascontiguousarray(q, dtype=np.int32)
    n = len(q)
    top = _top_of(n)
    mag = np.abs(q.astype(np.int64))
    # pass 1: best Rice k per bucket
    idx = np.arange(n, dtype=np.int64)
    lg = np.zeros(n, np.int64)
    if n:
        lg = (np.floor(np.log2(idx + 1))).astype(np.int64)
    buckets = np.minimum(lg * 8 // top, _BUCKETS - 1)
    ks = []
    big = mag > 2
    for b in range(_BUCKETS):
        rems = (mag[big & (buckets == b)] - 3).astype(np.int64)
        best, bk = None, 0
        for k in range(_MAX_K + 1):
            quo = rems >> k
            esc = quo >= _ESCAPE_Q
            c = int(np.sum(np.where(esc, _ESCAPE_Q + 32, quo + 1 + k)))
            if best is None or c < best:
                best, bk = c, k
        ks.append(bk)
    head = bytearray([_PROFILE_COND if cond is not None else _PROFILE])
    for b in range(0, _BUCKETS, 2):
        head.append(ks[b] | (ks[b + 1] << 4))
    stride = 1 if cond is None else 2
    cb = None if cond is None else (
        np.ascontiguousarray(cond, dtype=np.uint8) != 0
    )
    enc = _Encoder()
    for i in range(n):
        y = 0 if cb is None else int(cb[i])
        m = int(mag[i])
        enc.encode_bit(0 * stride + y, 1 if m else 0)
        if m == 0:
            continue
        enc.encode_direct(1 if q[i] < 0 else 0, 1)
        enc.encode_bit(1 * stride + y, 1 if m > 1 else 0)
        if m <= 1:
            continue
        enc.encode_bit(2 * stride + y, 1 if m > 2 else 0)
        if m <= 2:
            continue
        rem = m - 3
        k = ks[int(buckets[i])]
        quot = rem >> k
        if quot >= _ESCAPE_Q:
            for _ in range(_ESCAPE_Q):
                enc.encode_direct(1, 1)
            enc.encode_direct(rem, 32)
        else:
            for _ in range(quot):
                enc.encode_direct(1, 1)
            enc.encode_direct(0, 1)
            if k:
                enc.encode_direct(rem & ((1 << k) - 1), k)
    return bytes(head) + enc.finish()


def rac_decode_py(buf: bytes, n_decode: int, n_total: int,
                  out: np.ndarray = None,
                  cond: np.ndarray = None) -> np.ndarray:
    """Decode the first n_decode of n_total symbols; mirror of native
    rac_decode. ``cond`` must be given iff the stream is profile 1."""
    if n_decode > n_total:
        raise ValueError(f"n_decode {n_decode} > n_total {n_total}")
    want = _PROFILE if cond is None else _PROFILE_COND
    if len(buf) < 1 + _BUCKETS // 2 or buf[0] != want:
        raise ValueError("bad RAC stream: short header or unknown profile")
    ks = []
    for b in range(0, _BUCKETS, 2):
        ks.append(buf[1 + b // 2] & 0x0F)
        ks.append(buf[1 + b // 2] >> 4)
    top = _top_of(n_total)
    dec = _Decoder(buf[1 + _BUCKETS // 2:])
    if out is None:
        out = np.empty(n_decode, dtype=np.int32)
    stride = 1 if cond is None else 2
    cb = None if cond is None else (
        np.ascontiguousarray(cond, dtype=np.uint8) != 0
    )
    for i in range(n_decode):
        y = 0 if cb is None else int(cb[i])
        if not dec.decode_bit(0 * stride + y):
            out[i] = 0
            continue
        neg = dec.decode_direct(1)
        m = 1
        if dec.decode_bit(1 * stride + y):
            m = 2
            if dec.decode_bit(2 * stride + y):
                k = ks[_bucket_of(i, top)]
                quot = 0
                while quot < _ESCAPE_Q and dec.decode_direct(1):
                    quot += 1
                if quot >= _ESCAPE_Q:
                    rem = dec.decode_direct(32)
                else:
                    rem = (quot << k) | (dec.decode_direct(k) if k else 0)
                m = rem + 3
        v = -m if neg else m
        # int32 wrap mirrors the native narrowing (INT32_MIN roundtrips;
        # only hostile bytes can produce other out-of-range magnitudes)
        out[i] = (v + 2**31) % 2**32 - 2**31
    return out
