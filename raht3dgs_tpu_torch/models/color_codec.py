"""Colour point-cloud codec: the encode_ply workload.

Counterpart of ``raht3dgs_tpu/models/color_codec.py``, the reference
codec's canonical path as a function: RGB -> YUV (BT.709), RAHT, a sweep of
uniform quantization steps, RA-GFT reorder, per-channel RLGR, full decode,
and Y-PSNR against the 255 peak with the rate in bits per voxel.

Rate: payload bytes * 8 / Nvox. Distortion: Y-channel PSNR of the decoded
signal, or with ``decode=False`` in the coefficient domain (the transform
is orthonormal, so coefficient MSE equals signal MSE; the predicted
transform has no such shortcut and refuses ``decode=False``). A codec
with ``impl="golden"`` takes the reference's homogeneous YUV form
(``rgb_to_yuv_parity``, host numpy), as the JAX package does, for byte
parity with the reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from raht3dgs_tpu_torch.config import ColorCodecConfig as _CCC
from raht3dgs_tpu_torch.models.pipeline import (
    AttributeCodec,
    EncodedFrame,
    prepare_voxel_frame,
)
from raht3dgs_tpu_torch.ops.color import rgb_to_yuv, rgb_to_yuv_parity
from raht3dgs_tpu_torch.utils.device import DeviceLike, resolve_device, same_device
from raht3dgs_tpu_torch.utils.timing import StageTimer, spanned

DEFAULT_DEPTH = _CCC.depth
DEFAULT_STEPS = _CCC.steps

# The reference's 11-column CSV schema, verbatim, so reporting scripts read
# the port's logs unchanged.
CSV_HEADER = (
    "Frame,Quantization_Step,Rate_bpp,RAHT_prelude_time,RAHT_transform_time,"
    "Quant_time,Entropy_enc_time,Entropy_dec_time,Dequant_time,iRAHT_time,psnr"
)


@dataclass
class RDPoint:
    frame: int
    step: float
    bpp: float
    psnr: float
    n_voxels: int
    stream_bytes: int
    times: dict = field(default_factory=dict)
    encoded: Optional[EncodedFrame] = None

    def csv_row(self) -> str:
        t = self.times
        return (
            f"{self.frame},{self.step:g},{self.bpp:.6f},"
            f"{t.get('RAHT_prelude_time', 0.0):.6f},"
            f"{t.get('RAHT_transform_time', 0.0):.6f},"
            f"{t.get('Quant_time', 0.0):.6f},"
            f"{t.get('Entropy_enc_time', 0.0):.6f},"
            f"{t.get('Entropy_dec_time', 0.0):.6f},"
            # the schema has no decode-reorder column: it folds into Dequant
            # (both are decode-side coefficient preparation)
            f"{t.get('Dequant_time', 0.0) + t.get('Coeff_reorder_dec_time', 0.0):.6f},"
            f"{t.get('iRAHT_time', 0.0):.6f},"
            f"{self.psnr:.6f}"
        )


@spanned("psnr")
def y_psnr_db(y_ref: np.ndarray, y_rec: np.ndarray) -> float:
    """Y-channel PSNR against the 255 peak."""
    mse = float(np.mean((np.asarray(y_ref) - np.asarray(y_rec)) ** 2)) / 255.0**2
    if mse == 0:
        return float("inf")
    return -10.0 * np.log10(mse)


def encode_color_frame(
    V: np.ndarray,
    C_rgb: np.ndarray,
    depth: int = DEFAULT_DEPTH,
    steps: Sequence[float] = DEFAULT_STEPS,
    frame_index: int = 1,
    codec: Optional[AttributeCodec] = None,
    bucket: int = 1 << 13,
    dtype: torch.dtype = torch.float64,
    decode: bool = True,
    keep_streams: bool = False,
    *,
    device: DeviceLike = None,
) -> List[RDPoint]:
    """Run the full RD sweep on one frame; one RDPoint per step.

    ``V`` are integer voxel-grid positions (origin 0, width ``2**depth``).
    The transform runs once and serves every step (``encode_sweep``). Runs
    on the codec's device: CUDA unless ``device="cpu"`` (or a CPU codec).
    """
    timer = StageTimer()
    t0 = time.perf_counter()
    codec = codec or AttributeCodec(depth, dtype=dtype, device=device)
    if device is not None and not same_device(codec.device, resolve_device(device)):
        raise ValueError(f"codec runs on {codec.device}, not {device}")
    dev = codec.device
    if codec.impl == "golden":
        yuv = rgb_to_yuv_parity(np.asarray(C_rgb))
    else:
        yuv = rgb_to_yuv(torch.as_tensor(np.asarray(C_rgb), device=dev),
                         dtype=dtype).cpu().numpy()
    frame = prepare_voxel_frame(
        np.floor(np.asarray(V)).astype(np.int64), yuv, depth,
        bucket=bucket, dtype=dtype, device=dev,
    )
    timer.add("RAHT_prelude_time", time.perf_counter() - t0)

    if codec.predict:
        # the predicted transform runs its own closed loop inside
        # encode_sweep: no coefficients to hoist, no coefficient-domain PSNR
        if not decode:
            raise ValueError(
                "decode=False uses the coefficient-domain PSNR shortcut, "
                "which does not exist for the predicted transform"
            )
        coeffs = order = None
    else:
        coeffs, order, _, timer = codec.transform(frame, timer)
    # the coefficients cross to the host only for the coefficient-domain PSNR
    coeffs_np = None if decode else coeffs[: frame.n_voxels].cpu().numpy()
    # reference signal in the codec's (Morton-sorted) order
    yuv_sorted = frame.attributes[: frame.n_voxels].cpu().numpy()

    points: List[RDPoint] = []
    sweep = codec.encode_sweep(frame, [float(s) for s in steps], coeffs=coeffs,
                               order=order)
    for step, enc in zip(steps, sweep):
        st = enc.timer
        for k, v in timer.stages.items():  # per-frame stages, shared by the steps
            st.add(k, v)
        if decode:
            rec, st = codec.decode(enc.stream, frame.codes, frame.weights, timer=st)
            psnr = y_psnr_db(yuv_sorted[:, 0], rec[:, 0])
        else:
            q = np.floor(coeffs_np[:, 0] / step + 0.5)
            psnr = y_psnr_db(coeffs_np[:, 0], q * step)
        points.append(RDPoint(
            frame=frame_index, step=float(step), bpp=enc.stream.bpp(), psnr=psnr,
            n_voxels=frame.n_voxels, stream_bytes=enc.stream.payload_bytes,
            times=dict(st.stages), encoded=enc if keep_streams else None,
        ))
    return points
