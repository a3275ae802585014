"""The plain codec the benchmark judges the program's outputs against.

Float64 on the host: BT.709 colour conversion (``raht3dgs_tpu_torch/
ops/color.py:33``), the RAHT of :mod:`reference.raht` in the RA-GFT
order, the mid-rise quantizer ``floor(c / step + 0.5)`` and its
dequantizer ``q * step`` (``ops/quantize.py:53``), the RLGR coder of
:mod:`reference.entropy`, the Y PSNR against the 255 peak
(``models/color_codec.py:73``) and the 3DGS group PSNRs
(``eval/metrics.py:55``). :func:`judge_stream` turns one of the
program's streams, with the reconstruction and PSNRs it reported, into
the numbers that decide ``correct``. Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import entropy, raht

_RGB2YUV = ((0.2126, -0.114572, 0.5),
            (0.7152, -0.385428, -0.454153),
            (0.0722, 0.5, -0.045847))
_CHROMA_OFFSET = 0.50196078

# 3DGS payload groups: [quats(4), scales(3), opacity(1), SH colours(48)]
GS_GROUPS = {"quats": (0, 4), "scales": (4, 7), "opacity": (7, 8), "colors": (8, 56)}


def rgb_to_yuv(rgb: np.ndarray) -> np.ndarray:
    """RGB in [0, 255] to YUV in [0, 255], BT.709 full range, clipped."""
    yuv = (np.asarray(rgb, np.float64) / 255.0) @ np.asarray(_RGB2YUV)
    yuv += np.array([0.0, _CHROMA_OFFSET, _CHROMA_OFFSET])
    return np.clip(yuv, 0.0, 1.0) * 255.0


def y_psnr_db(ref: np.ndarray, rec: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(ref, np.float64) - rec) ** 2)) / 255.0 ** 2
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


def gs_group_psnr(orig: np.ndarray, rec: np.ndarray) -> Dict[str, float]:
    """``-10 log10(mse + 1e-10)`` over all channels and each group."""
    def psnr(a, b):
        return -10.0 * np.log10(float(np.mean((a - b) ** 2)) + 1e-10)
    out = {"psnr_all": psnr(orig, rec)}
    for name, (lo, hi) in GS_GROUPS.items():
        out[f"psnr_{name}"] = psnr(orig[:, lo:hi], rec[:, lo:hi])
    return out


class RefFrame:
    """One frame as the reference codes it: unique integer positions
    ``V (n, 3)`` and float64 attributes, sorted into Morton order, with the
    prelude and the float64 coefficients ``T (n, D)``."""

    def __init__(self, V: np.ndarray, attrs: np.ndarray, depth: int):
        codes = raht.morton_codes(V, depth)
        self.sort = np.argsort(codes, kind="stable")
        codes = codes[self.sort]
        if np.any(np.diff(codes) == 0):
            raise ValueError("duplicate voxel positions")
        self.n = len(codes)
        self.depth = depth
        self.attrs = np.asarray(attrs, np.float64)[self.sort]
        self.pre = raht.prelude(codes, 3 * depth)
        self.order = self.pre[3]
        self.T = raht.forward(torch.from_numpy(self.attrs), self.pre).numpy()

    def symbols(self, steps, dtype=torch.float64) -> np.ndarray:
        """``(D, n)`` stream-order symbols of a codec computing in ``dtype``
        (the control's lower precision; float64 is the reference itself)."""
        T = self.T if dtype == torch.float64 else raht.forward(
            torch.from_numpy(self.attrs).to(dtype), self.pre, dtype)
        T = torch.as_tensor(T)[torch.from_numpy(self.order)].to(dtype)
        st = torch.as_tensor(np.broadcast_to(np.asarray(steps, np.float64),
                                             (T.shape[1],)).copy()).to(dtype)
        return torch.floor(T / st + 0.5).to(torch.int64).T.numpy()

    def reconstruct(self, q: np.ndarray, steps, dtype=torch.float64) -> np.ndarray:
        """Attributes (n, D), Morton order, from stream-order symbols."""
        st = np.broadcast_to(np.asarray(steps, np.float64), (q.shape[0],))
        coeffs = np.empty((self.n, q.shape[0]), np.float64)
        coeffs[self.order] = q.T * st
        return raht.inverse(torch.from_numpy(coeffs).to(dtype), self.pre, dtype) \
            .to(torch.float64).numpy()


def judge_stream(ref: RefFrame, data: bytes, steps, *, rec: Optional[np.ndarray] = None,
                 reencode: Optional[Sequence[int]] = None
                 ) -> Tuple[Dict[str, float], Optional[np.ndarray]]:
    """Judge one stream's bytes: parse it, decode every channel, re-encode
    the symbols of every channel (or of ``reencode``) and compare the
    bytes, measure how far, in steps, a symbol lies past the rounding
    interval of the float64 coefficient (``sym_gap``: 0 when every symbol
    is the reference's own rounding, a hair past on a float32 tie) and,
    with ``rec``, the reconstruction's largest difference to the
    reference's from those symbols. Returns the numbers and the reference
    reconstruction (None when the header is wrong)."""
    s = entropy.read_stream(data)
    D = ref.T.shape[1]
    want = np.broadcast_to(np.asarray(steps, np.float64), (D,))
    got = np.broadcast_to(s.steps, (D,))
    header_ok = (s.n_voxels == ref.n and s.depth == ref.depth and len(s.channels) == D
                 and np.array_equal(got, want))
    out = {"header_diff": 0.0 if header_ok else 1.0}
    if not header_ok:
        return out, None
    q = np.zeros((D, ref.n), np.int64)
    bytes_diff = 0
    for d in range(D):
        q[d] = entropy.decode(s.channels[d], ref.n)
        if reencode is None or d in reencode:
            bytes_diff += entropy.encode(q[d]) != s.channels[d]
    out["stream_diff"] = float(bytes_diff)
    c = ref.T[ref.order].T / want[:, None]
    out["sym_gap"] = float(max(np.abs(c - q).max() - 0.5, 0.0))
    R = ref.reconstruct(q, want)
    if rec is not None:
        rec = np.asarray(rec, np.float64)
        out["rec_err"] = float(np.abs(rec - R).max()) if rec.shape == R.shape else float("inf")
    return out, R
