"""Plain Python geometry entropy coder, a bit-exact mirror of native/geom.cpp.

Counterpart of ``raht3dgs_tpu/codec/_geom_py.py``. The port codes through
the native library (``codec/geometry.py``); this twin runs only when a
caller names it (``backend="python"``), and the tests hold the library's
bytes against it. The automaton (LZMA-style carry-less binary range coder,
12-bit probabilities, shift-5 adaptation, level-banked binary-tree
contexts over LSB-first occupancy bits, forced-one last bit) is a frozen
stream format. One range encoder / decoder pair serves the intra
functions and the temporal classes.
"""

from __future__ import annotations

import numpy as np

from raht3dgs_tpu_torch.ops.octree import _BITS8, level_neighbors6, octree_levels

_PROB_BITS = 12
_PROB_INIT = 1 << (_PROB_BITS - 1)
_ADAPT_SHIFT = 5
_TOP = 1 << 24
_LEVEL_BANKS = 8
_TREE_CTX = 256
_NUM_CTX = _LEVEL_BANKS * _TREE_CTX
_MASK32 = 0xFFFFFFFF

# temporal (profile 1/2) context layout: (level bank, tflag, tree node),
# tflag in {0: unmatched, 2: prev bit 0, 3: prev bit 1} (1 reserved)
_TFLAG_CTX = 4
_NUM_CTX_T = _LEVEL_BANKS * _TFLAG_CTX * _TREE_CTX


def _bank_base(level: int) -> int:
    return min(level, _LEVEL_BANKS - 1) * _TREE_CTX


def _bank_base_t(level: int, tflag: int) -> int:
    return (min(level, _LEVEL_BANKS - 1) * _TFLAG_CTX + tflag) * _TREE_CTX


class _RangeEncoder:
    """LZMA-style carry-less binary range encoder over a probs table."""

    def __init__(self, n_ctx: int):
        self.out = bytearray()
        self._low = 0
        self._rng = _MASK32
        self._cache = 0
        self._cache_size = 1
        self.probs = [_PROB_INIT] * n_ctx

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

    def encode_byte(self, base: int, b: int):
        """One occupancy byte over the binary-tree contexts at ``base``."""
        ctx = 1
        for i in range(8):
            bit = (b >> i) & 1
            if i == 7 and ctx == 1:
                break  # forced 1: byte can't be zero
            self.encode_bit(base + ctx, bit)
            ctx = (ctx << 1) | bit

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class _RangeDecoder:
    """Decoder counterpart of :class:`_RangeEncoder`."""

    def __init__(self, buf: bytes, n_ctx: int):
        self._buf = buf
        self._blen = len(buf)
        self._bpos = 1  # skip the initial cache byte (always 0)
        self._rng = _MASK32
        self.probs = [_PROB_INIT] * n_ctx
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
            self._code = (
                (self._code << 8)
                | (self._buf[self._bpos] if self._bpos < self._blen else 0)
            ) & _MASK32
            self._bpos += 1
            self._rng = (self._rng << 8) & _MASK32
        return bit

    def decode_byte(self, base: int) -> int:
        ctx = 1
        b = 0
        for i in range(8):
            if i == 7 and ctx == 1:
                bit = 1  # forced: occupancy bytes are never zero
            else:
                bit = self.decode_bit(base + ctx)
            b |= bit << i
            ctx = (ctx << 1) | bit
        return b


# -- intra coder (geometry profile 0) ------------------------------------------


def encode(occ: np.ndarray, depth: int) -> bytes:
    occ_list = np.asarray(occ, dtype=np.uint8).tolist()
    n = len(occ_list)
    if n == 0 or depth == 0:
        raise ValueError("occupancy level walk inconsistent with input")
    enc = _RangeEncoder(_NUM_CTX)
    pos, n_nodes = 0, 1
    for level in range(depth):
        if pos + n_nodes > n:
            raise ValueError("occupancy level walk inconsistent with input")
        base = _bank_base(level)
        next_nodes = 0
        for j in range(pos, pos + n_nodes):
            b = occ_list[j]
            if b == 0:
                raise ValueError("zero occupancy byte")
            next_nodes += bin(b).count("1")
            enc.encode_byte(base, b)
        pos += n_nodes
        n_nodes = next_nodes
    if pos != n:
        raise ValueError("occupancy level walk inconsistent with input")
    return enc.finish()


def decode(buf: bytes, depth: int, max_bytes: int) -> np.ndarray:
    if depth == 0 or max_bytes == 0:
        raise ValueError("decoded occupancy walk exceeds capacity")
    dec = _RangeDecoder(buf, _NUM_CTX)
    out = []
    pos, n_nodes = 0, 1
    for level in range(depth):
        if pos + n_nodes > max_bytes:
            raise ValueError(
                "decoded occupancy walk exceeds capacity (corrupt stream?)"
            )
        base = _bank_base(level)
        next_nodes = 0
        for _ in range(n_nodes):
            b = dec.decode_byte(base)
            out.append(b)
            next_nodes += bin(b).count("1")
        pos += n_nodes
        n_nodes = next_nodes
    return np.asarray(out, dtype=np.uint8)


def decode_codes_lod(
    buf: bytes, depth: int, max_level: int, cap: int
) -> np.ndarray:
    """LOD (prefix) decode of a profile-0 payload: walk octree levels
    0..max_level-1 only and return the uint64 node codes AT ``max_level``
    (coarse positions, 3*max_level bits). Breadth-first order makes the
    level cut a stream prefix — the range decoder stops early; no CRC
    (it covers the full walk). Mirrors native geom_decode_codes_lod."""
    if depth == 0 or cap == 0:
        raise ValueError("decoded occupancy walk exceeds capacity")
    if max_level < 1 or max_level > depth:
        raise ValueError(f"max_level must be in 1..{depth}, got {max_level}")

    dec = _RangeDecoder(buf, _NUM_CTX)
    level_codes = np.zeros(1, dtype=np.uint64)
    for level in range(max_level):
        if level_codes.size > cap:
            raise ValueError(
                "decoded occupancy walk exceeds capacity (corrupt stream?)"
            )
        base = _bank_base(level)
        out = np.empty(level_codes.size, dtype=np.uint8)
        for j in range(level_codes.size):
            out[j] = dec.decode_byte(base)
        rows, cols = np.nonzero(_BITS8[out])
        level_codes = (level_codes[rows] << np.uint64(3)) | cols.astype(
            np.uint64
        )
        if level_codes.size > cap:
            raise ValueError(
                "decoded occupancy walk exceeds capacity (corrupt stream?)"
            )
    return level_codes


def decode3_lod(
    buf: bytes, depth: int, max_level: int, cap: int
) -> np.ndarray:
    """Profile-3 counterpart of :func:`decode_codes_lod` (ext3 contexts)."""
    if depth == 0 or cap == 0:
        raise ValueError("decoded occupancy walk exceeds capacity")
    if max_level < 1 or max_level > depth:
        raise ValueError(f"max_level must be in 1..{depth}, got {max_level}")

    dec = _RangeDecoder(buf, _NUM_CTX3)
    level_codes = np.zeros(1, dtype=np.uint64)
    for level in range(max_level):
        if level_codes.size > cap:
            raise ValueError(
                "decoded occupancy walk exceeds capacity (corrupt stream?)"
            )
        n6 = level_neighbors6(level_codes, level).tolist()
        out = np.empty(level_codes.size, dtype=np.uint8)
        for j in range(level_codes.size):
            ctx = 1
            b = 0
            for i in range(8):
                if i == 7 and ctx == 1:
                    bit = 1  # forced: occupancy bytes are never zero
                else:
                    bit = dec.decode_bit(
                        _bank_base3(level, _ext3_of(n6[j], i)) + ctx
                    )
                b |= bit << i
                ctx = (ctx << 1) | bit
            out[j] = b
        rows, cols = np.nonzero(_BITS8[out])
        level_codes = (level_codes[rows] << np.uint64(3)) | cols.astype(
            np.uint64
        )
        if level_codes.size > cap:
            raise ValueError(
                "decoded occupancy walk exceeds capacity (corrupt stream?)"
            )
    return level_codes


# -- temporal coder (geometry profiles 1-2) -------------------------------------
# Stateful level-by-level mirror of native/geom.cpp's geom_enc_*/geom_dec_*.


class TemporalEncoder:
    def __init__(self):
        self._enc = _RangeEncoder(_NUM_CTX_T)

    def encode_level(self, occ, matched, prevbyte, level: int):
        occ = np.asarray(occ, dtype=np.uint8).tolist()
        matched = np.asarray(matched, dtype=np.uint8).tolist()
        prevbyte = np.asarray(prevbyte, dtype=np.uint8).tolist()
        enc = self._enc
        for j, b in enumerate(occ):
            if b == 0:
                raise ValueError("zero occupancy byte")
            m = matched[j] != 0
            pb = prevbyte[j]
            ctx = 1
            for i in range(8):
                bit = (b >> i) & 1
                if i == 7 and ctx == 1:
                    break  # forced 1: byte can't be zero
                tflag = (2 + ((pb >> i) & 1)) if m else 0
                enc.encode_bit(_bank_base_t(level, tflag) + ctx, bit)
                ctx = (ctx << 1) | bit

    def finish(self) -> bytes:
        return self._enc.finish()


class TemporalDecoder:
    def __init__(self, buf: bytes):
        self._dec = _RangeDecoder(buf, _NUM_CTX_T)

    def decode_level(self, matched, prevbyte, n: int, level: int):
        matched = np.asarray(matched, dtype=np.uint8).tolist()
        prevbyte = np.asarray(prevbyte, dtype=np.uint8).tolist()
        dec = self._dec
        out = np.empty(n, dtype=np.uint8)
        for j in range(n):
            m = matched[j] != 0
            pb = prevbyte[j]
            ctx = 1
            b = 0
            for i in range(8):
                if i == 7 and ctx == 1:
                    bit = 1  # forced: occupancy bytes are never zero
                else:
                    tflag = (2 + ((pb >> i) & 1)) if m else 0
                    bit = dec.decode_bit(_bank_base_t(level, tflag) + ctx)
                b |= bit << i
                ctx = (ctx << 1) | bit
            out[j] = b
        return out


# -- ext3-context coders (geometry profiles 3-5) --------------------------------
# Mirror of native/geom.cpp's geom_*_codes3 / geom_*_level4. The ext3
# feature (same-level face-neighbor occupancy on the child's outward
# sides) is computed from ops/octree.py:level_neighbors6 — the native
# intra path computes it in C; byte-identity tests pin the two.

_EXT_CTX = 8
_NUM_CTX3 = _LEVEL_BANKS * _EXT_CTX * _TREE_CTX
_NUM_CTX_T4 = _LEVEL_BANKS * _TFLAG_CTX * _EXT_CTX * _TREE_CTX


def _ext3_of(n6: int, i: int) -> int:
    ex = (n6 >> ((i >> 2) & 1)) & 1
    ey = (n6 >> (2 + ((i >> 1) & 1))) & 1
    ez = (n6 >> (4 + (i & 1))) & 1
    return (ex << 2) | (ey << 1) | ez


def _bank_base3(level: int, ext3: int) -> int:
    return (min(level, _LEVEL_BANKS - 1) * _EXT_CTX + ext3) * _TREE_CTX


def _bank_base_t4(level: int, tflag: int, ext3: int) -> int:
    return ((min(level, _LEVEL_BANKS - 1) * _TFLAG_CTX + tflag) * _EXT_CTX
            + ext3) * _TREE_CTX


def encode3(codes: np.ndarray, depth: int):
    """Profile-3 intra encode from sorted unique leaf codes.

    Returns ``(payload bytes, crc32 of the occupancy bytes)`` — the same
    contract as the fused native ``geom_encode_codes3``.
    """
    import zlib


    lv, occ = octree_levels(codes, depth)
    enc = _RangeEncoder(_NUM_CTX3)
    for level in range(depth):
        n6 = level_neighbors6(lv[level], level).tolist()
        for j, b in enumerate(np.asarray(occ[level]).tolist()):
            ctx = 1
            for i in range(8):
                bit = (b >> i) & 1
                if i == 7 and ctx == 1:
                    break  # forced 1: byte can't be zero
                enc.encode_bit(
                    _bank_base3(level, _ext3_of(n6[j], i)) + ctx, bit
                )
                ctx = (ctx << 1) | bit
    crc = zlib.crc32(np.concatenate(occ).tobytes())
    return enc.finish(), crc


def decode3(buf: bytes, depth: int, n_voxels: int):
    """Profile-3 intra decode: payload -> (sorted leaf codes uint64, crc)."""
    import zlib


    dec = _RangeDecoder(buf, _NUM_CTX3)
    level_codes = np.zeros(1, dtype=np.uint64)
    crc = 0
    for level in range(depth):
        if level_codes.size > n_voxels:
            raise ValueError(
                "decoded occupancy walk exceeds capacity (corrupt stream?)"
            )
        n6 = level_neighbors6(level_codes, level).tolist()
        out = np.empty(level_codes.size, dtype=np.uint8)
        for j in range(level_codes.size):
            ctx = 1
            b = 0
            for i in range(8):
                if i == 7 and ctx == 1:
                    bit = 1  # forced: occupancy bytes are never zero
                else:
                    bit = dec.decode_bit(
                        _bank_base3(level, _ext3_of(n6[j], i)) + ctx
                    )
                b |= bit << i
                ctx = (ctx << 1) | bit
            out[j] = b
        crc = zlib.crc32(out.tobytes(), crc)
        rows, cols = np.nonzero(_BITS8[out])
        level_codes = (level_codes[rows] << np.uint64(3)) | cols.astype(
            np.uint64
        )
        if level_codes.size > n_voxels:
            raise ValueError(
                "decoded occupancy walk exceeds capacity (corrupt stream?)"
            )
    return level_codes, crc


class TemporalEncoder4:
    """Profiles 4-5: temporal contexts + ext3 (n6 passed per level)."""

    def __init__(self):
        self._enc = _RangeEncoder(_NUM_CTX_T4)

    def encode_level(self, occ, matched, prevbyte, n6, level: int):
        occ = np.asarray(occ, dtype=np.uint8).tolist()
        matched = np.asarray(matched, dtype=np.uint8).tolist()
        prevbyte = np.asarray(prevbyte, dtype=np.uint8).tolist()
        n6 = np.asarray(n6, dtype=np.uint8).tolist()
        enc = self._enc
        for j, b in enumerate(occ):
            if b == 0:
                raise ValueError("zero occupancy byte")
            m = matched[j] != 0
            pb = prevbyte[j]
            ctx = 1
            for i in range(8):
                bit = (b >> i) & 1
                if i == 7 and ctx == 1:
                    break  # forced 1: byte can't be zero
                tflag = (2 + ((pb >> i) & 1)) if m else 0
                enc.encode_bit(
                    _bank_base_t4(level, tflag, _ext3_of(n6[j], i)) + ctx,
                    bit,
                )
                ctx = (ctx << 1) | bit

    def finish(self) -> bytes:
        return self._enc.finish()


class TemporalDecoder4:
    def __init__(self, buf: bytes):
        self._dec = _RangeDecoder(buf, _NUM_CTX_T4)

    def decode_level(self, matched, prevbyte, n6, n: int, level: int):
        matched = np.asarray(matched, dtype=np.uint8).tolist()
        prevbyte = np.asarray(prevbyte, dtype=np.uint8).tolist()
        n6 = np.asarray(n6, dtype=np.uint8).tolist()
        dec = self._dec
        out = np.empty(n, dtype=np.uint8)
        for j in range(n):
            m = matched[j] != 0
            pb = prevbyte[j]
            ctx = 1
            b = 0
            for i in range(8):
                if i == 7 and ctx == 1:
                    bit = 1  # forced: occupancy bytes are never zero
                else:
                    tflag = (2 + ((pb >> i) & 1)) if m else 0
                    bit = dec.decode_bit(
                        _bank_base_t4(level, tflag, _ext3_of(n6[j], i))
                        + ctx
                    )
                b |= bit << i
                ctx = (ctx << 1) | bit
            out[j] = b
        return out
