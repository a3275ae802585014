"""Colour-space transforms (BT.709 full range) for point-cloud attributes.

Counterpart of ``raht3dgs_tpu/ops/color.py``: RGB in [0, 255] is scaled to
[0, 1], transformed by the BT.709 full-range matrix with the reference's
0.50196078 chroma offset, clamped to [0, 1] and rescaled to [0, 255].
Divisions are by tensors on the data's device (PyTorch's CUDA division by a
host scalar multiplies by the reciprocal, which rounds differently).
"""

from __future__ import annotations

import numpy as np
import torch

from raht3dgs_tpu_torch.utils.device import DeviceLike, device_of

# columns are (Y, U, V) weights for (R, G, B)
_RGB2YUV = (
    (0.2126, -0.114572, 0.5),
    (0.7152, -0.385428, -0.454153),
    (0.0722, 0.5, -0.045847),
)
_CHROMA_OFFSET = 0.50196078  # the reference's literal, not 128/255


def _as_rows3(x, dtype, device: DeviceLike) -> torch.Tensor:
    t = torch.as_tensor(x, device=device_of(x, device)).to(dtype)
    if t.dim() != 2 or t.shape[1] != 3:
        raise ValueError(f"expected (N, 3) array, got {tuple(t.shape)}")
    return t


def rgb_to_yuv(rgb, dtype=torch.float64, *, device: DeviceLike = None) -> torch.Tensor:
    """RGB [0,255] -> YUV [0,255] (BT.709 full range, clipped)."""
    rgb = _as_rows3(rgb, dtype, device)
    c255 = torch.tensor(255.0, dtype=dtype, device=rgb.device)
    M = torch.tensor(_RGB2YUV, dtype=dtype, device=rgb.device)
    off = torch.tensor([0.0, _CHROMA_OFFSET, _CHROMA_OFFSET], dtype=dtype,
                       device=rgb.device)
    yuv = (rgb / c255) @ M + off
    return torch.clamp(yuv, 0.0, 1.0) * c255


def rgb_to_yuv_parity(rgb) -> np.ndarray:
    """Bitwise replication of the reference ``rgb_to_yuv`` on host: the
    homogeneous ``hstack(rgb/255, 1) @ Q`` form in numpy float64."""
    rgb = np.asarray(rgb, dtype=np.float64)
    if rgb.ndim != 2 or rgb.shape[1] != 3:
        raise ValueError(f"expected (N, 3) array, got {rgb.shape}")
    Q = np.array([*_RGB2YUV, (0.0, _CHROMA_OFFSET, _CHROMA_OFFSET)])
    rgb1 = np.hstack([rgb / 255.0, np.ones((rgb.shape[0], 1))])
    return np.clip(rgb1 @ Q, 0.0, 1.0) * 255.0


def yuv_to_rgb(yuv, dtype=torch.float64, *, device: DeviceLike = None) -> torch.Tensor:
    """Inverse of :func:`rgb_to_yuv` (modulo the forward clipping)."""
    yuv = _as_rows3(yuv, dtype, device)
    c255 = torch.tensor(255.0, dtype=dtype, device=yuv.device)
    off = torch.tensor([0.0, _CHROMA_OFFSET, _CHROMA_OFFSET], dtype=dtype,
                       device=yuv.device)
    Minv = torch.linalg.inv(torch.tensor(_RGB2YUV, dtype=torch.float64))
    rgb = (yuv / c255 - off) @ Minv.to(dtype=dtype, device=yuv.device)
    return torch.clamp(rgb, 0.0, 1.0) * c255
