"""A small PNG writer (8-bit RGB, standard library only).

The serving CLI and the render comparison write their views as PNG files;
the machines that run the port on the card carry no imaging package, so
the files are written here with ``zlib`` and ``struct``: one IHDR (8-bit
RGB, no interlace), one IDAT of unfiltered scanlines (filter type 0 on
every row), one IEND. Any PNG reader returns the given pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def png_bytes(img: np.ndarray) -> bytes:
    """The PNG file of an (H, W, 3) uint8 image."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"png: need an (H, W, 3) uint8 image, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, 3 * w)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG file."""
    with open(path, "wb") as f:
        f.write(png_bytes(img))
