"""What a viewer's serving path renders from one frame's R3TC bytes, as the
benchmark's reference computes it: the stream's header judged, its
symbols decoded (:mod:`reference.entropy`), dequantized at its one step
and inverse-transformed (:mod:`reference.raht`) at the frame's voxels, and
the 56-channel payload turned into the scene :mod:`reference.raster`
renders. Imports nothing of the program.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from portbench.reference import entropy, raht, raster

_HEAD = struct.Struct("<4sBBBHQH")


def plain_frame(data: bytes) -> bytes:
    """An R3TC v4 frame without its lossless geometry section (a ``u32``
    length and the section, after the header's steps, vmin and width): the
    plain v2 frame ``entropy.read_stream`` reads. Any other frame as it is."""
    magic, version, flags, depth, nch, nvox, nsteps = _HEAD.unpack_from(data)
    if version != 4:
        return data
    off = _HEAD.size + 8 * nsteps + 8 * 3 + 8
    (glen,) = struct.unpack_from("<I", data, off)
    return data[:4] + bytes([2]) + data[5:off] + data[off + 4 + glen:]


def served_scene(blob: bytes, V: np.ndarray, voxel_size: float, vmin, *, depth: int,
                 channels: int, step: float, dtype=torch.float64
                 ) -> Tuple[Dict[str, float], Optional[tuple]]:
    """``(numbers, scene)`` of one frame's bytes ``blob`` coded at the
    integer voxels ``V (n, 3)``: ``header_diff`` 0 when the header holds
    ``n`` voxels at ``depth``, ``channels`` channels and the one step
    ``step``, else 1; the scene (``raster.scene_from_payload``, Morton
    order) decoded in ``dtype``, or None when the header is wrong."""
    st = entropy.read_stream(plain_frame(blob))
    n = len(V)
    header_ok = (st.n_voxels == n and st.depth == depth and len(st.channels) == channels
                 and np.array_equal(st.steps, [float(step)]))
    if not header_ok:
        return {"header_diff": 1.0}, None
    codes = raht.morton_codes(V, depth)
    srt = np.argsort(codes, kind="stable")
    pre = raht.prelude(codes[srt], 3 * depth)
    coeffs = np.empty((n, channels), np.float64)
    coeffs[pre[3]] = np.stack([entropy.decode(c, n) for c in st.channels], 1) * st.steps[0]
    attrs = raht.inverse(torch.from_numpy(coeffs).to(dtype), pre, dtype).double().numpy()
    return {"header_diff": 0.0}, raster.scene_from_payload(V[srt], attrs, voxel_size, vmin,
                                                           dtype)
