"""Octree occupancy (de)serialization for lossless geometry coding.

Counterpart of ``raht3dgs_tpu/ops/octree.py``, numpy in and numpy out as
there (the host tier of the geometry coder; the device never sees
geometry bytes). The sorted unique Morton codes of a frame are a depth-J
octree, and a breadth-first walk of it is fully described by one
*occupancy byte* per internal node (bit c set == child ``c`` occupied):

- serialize: per level, group sorted child codes by parent with
  ``np.bitwise_or.reduceat`` at group starts;
- deserialize: per level, expand each occupancy byte into its set bits
  with one ``np.nonzero`` on an ``(n_nodes, 8)`` bit matrix; row-major
  order of the result is sorted Morton order, so the rebuild needs no sort.

The byte stream is self-framing given ``depth``: level 0 is one byte (the
root), and each level's node count is the popcount sum of the previous
level's bytes.
"""

from __future__ import annotations

import numpy as np

_U3 = np.uint64(3)
_U7 = np.uint64(7)

_POPCOUNT8 = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1
).sum(axis=1).astype(np.int64)

# child-bit expansion table: _BITS8[b] = bool row of b's 8 bits, LSB first
_BITS8 = (
    (np.arange(256, dtype=np.uint8)[:, None] >> np.arange(8, dtype=np.uint8))
    & 1
).astype(bool)


def octree_levels(codes: np.ndarray, depth: int):
    """Per-level structure of the octree over sorted unique Morton codes.

    Returns ``(level_codes, level_occ)``: for each level l in 0..depth-1,
    ``level_codes[l]`` is the sorted node codes (uint64, 3*l bits) and
    ``level_occ[l]`` the matching occupancy bytes. The temporal geometry
    coder (``codec/geometry.py`` profiles 1-2, 4-5) uses these to align nodes
    across frames; ``octree_serialize`` is the flat concatenation of
    ``level_occ``.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    codes = np.asarray(codes)
    if codes.ndim != 1:
        raise ValueError(f"codes must be 1-D, got shape {codes.shape}")
    if codes.size == 0:
        raise ValueError("cannot serialize an empty octree (n_voxels == 0)")
    u = codes.astype(np.uint64)
    if codes.dtype.kind == "i" and np.any(codes < 0):
        raise ValueError("negative Morton codes")
    if depth < 22 and np.any(u >= np.uint64(1) << np.uint64(3 * depth)):
        raise ValueError(f"codes exceed 3*depth = {3 * depth} bits")
    if np.any(u[1:] <= u[:-1]):
        raise ValueError("codes must be strictly increasing (sorted unique)")

    occ_rev, codes_rev = [], []
    level_codes = u
    for _ in range(depth):
        parents = level_codes >> _U3
        child = (level_codes & _U7).astype(np.uint8)
        starts = np.flatnonzero(
            np.concatenate([[True], parents[1:] != parents[:-1]])
        )
        occ_rev.append(
            np.bitwise_or.reduceat(np.left_shift(np.uint8(1), child), starts)
        )
        level_codes = parents[starts]
        codes_rev.append(level_codes)
    assert level_codes.size == 1 and level_codes[0] == 0
    return codes_rev[::-1], occ_rev[::-1]


def octree_serialize(codes: np.ndarray, depth: int) -> np.ndarray:
    """Sorted unique Morton codes -> breadth-first occupancy bytes.

    Args:
        codes: ``(N,)`` strictly increasing Morton codes in
            ``[0, 2**(3*depth))`` (any integer dtype; values are taken as
            unsigned).
        depth: octree depth J >= 1.

    Returns:
        ``(M,)`` uint8 occupancy bytes, levels 0..depth-1 concatenated,
        nodes within a level in sorted (Morton) order. ``M`` is the number
        of internal (occupied, non-leaf) octree nodes.
    """
    _, occ = octree_levels(codes, depth)
    return np.concatenate(occ)


def octree_deserialize(occ: np.ndarray, depth: int,
                       dtype=np.uint64) -> np.ndarray:
    """Inverse of :func:`octree_serialize`: occupancy bytes -> sorted codes.

    Raises ``ValueError`` on malformed input (zero occupancy byte, stream
    too short / too long for ``depth``) — corrupt geometry must never
    silently decode.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    occ = np.asarray(occ, dtype=np.uint8)
    if occ.ndim != 1:
        raise ValueError(f"occupancy must be 1-D, got shape {occ.shape}")
    pos = 0
    level_codes = np.zeros(1, dtype=np.uint64)
    for lvl in range(depth):
        n_nodes = level_codes.size
        if pos + n_nodes > occ.size:
            raise ValueError(
                f"truncated occupancy stream: level {lvl} needs {n_nodes} "
                f"bytes at offset {pos}, have {occ.size}"
            )
        b = occ[pos : pos + n_nodes]
        pos += n_nodes
        if np.any(b == 0):
            raise ValueError(
                f"corrupt occupancy stream: zero byte at level {lvl} "
                "(an occupied node must have at least one child)"
            )
        rows, cols = np.nonzero(_BITS8[b])
        level_codes = (level_codes[rows] << _U3) | cols.astype(np.uint64)
    if pos != occ.size:
        raise ValueError(
            f"occupancy stream has {occ.size - pos} trailing bytes "
            f"beyond depth {depth}"
        )
    out = level_codes.astype(dtype)
    if np.dtype(dtype) != np.uint64 and np.any(
        out.astype(np.uint64) != level_codes
    ):
        raise ValueError(f"decoded codes overflow dtype {np.dtype(dtype)}")
    return out


def occupancy_level_sizes(occ: np.ndarray, depth: int) -> np.ndarray:
    """Per-level node counts of a serialized stream (levels 0..depth-1).

    Inspection/validation utility sharing the self-framing rule with
    :func:`octree_deserialize` without materializing codes (the entropy
    coders walk levels inline; see native/geom.cpp).
    """
    occ = np.asarray(occ, dtype=np.uint8)
    sizes = np.empty(depth, dtype=np.int64)
    pos, n_nodes = 0, 1
    for lvl in range(depth):
        if pos + n_nodes > occ.size:
            raise ValueError(
                f"truncated occupancy stream: level {lvl} needs {n_nodes} "
                f"bytes at offset {pos}, have {occ.size}"
            )
        sizes[lvl] = n_nodes
        nxt = int(_POPCOUNT8[occ[pos : pos + n_nodes]].sum())
        pos += n_nodes
        n_nodes = nxt
    if pos != occ.size:
        raise ValueError(
            f"occupancy stream has {occ.size - pos} trailing bytes "
            f"beyond depth {depth}"
        )
    return sizes


def _compact3(x: np.ndarray) -> np.ndarray:
    """Gather every 3rd bit (LSB first) of uint64 words into the low bits."""
    m = np.uint64
    x = x & m(0x1249249249249249)
    x = (x | (x >> m(2))) & m(0x10C30C30C30C30C3)
    x = (x | (x >> m(4))) & m(0x100F00F00F00F00F)
    x = (x | (x >> m(8))) & m(0x001F0000FF0000FF)
    x = (x | (x >> m(16))) & m(0x001F00000000FFFF)
    x = (x | (x >> m(32))) & m(0x00000000001FFFFF)
    return x


def _spread3(x: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_compact3`: spread low 21 bits to every 3rd bit."""
    m = np.uint64
    x = x & m(0x00000000001FFFFF)
    x = (x | (x << m(32))) & m(0x001F00000000FFFF)
    x = (x | (x << m(16))) & m(0x001F0000FF0000FF)
    x = (x | (x << m(8))) & m(0x100F00F00F00F00F)
    x = (x | (x << m(4))) & m(0x10C30C30C30C30C3)
    x = (x | (x << m(2))) & m(0x1249249249249249)
    return x


def level_neighbors6(codes_l: np.ndarray, level: int) -> np.ndarray:
    """Face-neighbor occupancy of each level-``level`` node, at the same
    level's granularity: bit 0 = x-, 1 = x+, 2 = y-, 3 = y+, 4 = z-,
    5 = z+ (Morton digit = z + 2y + 4x, so x rides bit 2 of each digit).

    The ext3-context geometry profiles (codec/geometry.py profiles 3-5)
    condition each occupancy bit on the three of these bits on the child's
    outward sides. Available to the decoder before any level-``level``
    byte is read: the full node set of a level is known once the previous
    level's bytes are decoded. This numpy definition and the C mirror in
    native/geom.cpp are pinned to each other by the backend byte-identity
    tests.
    """
    codes_l = np.asarray(codes_l).astype(np.uint64)
    n = codes_l.size
    out = np.zeros(n, dtype=np.uint8)
    if level == 0 or n == 0:
        return out
    lim = np.uint64((1 << level) - 1)
    axes = (
        _compact3(codes_l >> np.uint64(2)),  # x
        _compact3(codes_l >> np.uint64(1)),  # y
        _compact3(codes_l),                  # z
    )
    bit = 0
    for a in range(3):
        coord = axes[a]
        others = codes_l & ~(_spread3(lim) << np.uint64(2 - a))
        for d in (-1, 1):
            if d < 0:
                valid = coord > 0
                nc = coord - np.uint64(1)
            else:
                valid = coord < lim
                nc = coord + np.uint64(1)
            ncode = others | (_spread3(nc & lim) << np.uint64(2 - a))
            pos = np.searchsorted(codes_l, ncode)
            pos = np.minimum(pos, n - 1)
            hit = (codes_l[pos] == ncode) & valid
            out |= (hit.astype(np.uint8) << np.uint8(bit))
            bit += 1
    return out
