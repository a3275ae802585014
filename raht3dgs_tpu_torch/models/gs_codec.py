"""3DGS 56-channel attribute codec: the encode_3dgs workload.

Counterpart of ``raht3dgs_tpu/models/gs_codec.py``: an RD sweep over the
whole Gaussian payload [quats(4), scales(3), opacity(1), SH colours(48)]
of a voxelized scene. RAHT over all 56 channels at once (on the card the
float32 transform's (N, 57) prefix pack goes through the scan kernel's
wide path), uniform or per-attribute-group steps, per-channel RLGR, full
decode, overall and per-group PSNR, and the reference's 19-column CSV. A
predicted codec (``predict=True``) runs its closed loop inside
``encode_sweep``, step by step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from raht3dgs_tpu_torch.config import GsCodecConfig as _GCC
from raht3dgs_tpu_torch.eval.metrics import gs_group_psnr
from raht3dgs_tpu_torch.models.pipeline import (
    AttributeCodec,
    EncodedFrame,
    prepare_voxel_frame,
)
from raht3dgs_tpu_torch.ops.quantize import channel_steps
from raht3dgs_tpu_torch.utils.device import DeviceLike, resolve_device, same_device, to_host
from raht3dgs_tpu_torch.utils.timing import StageTimer, spanned

DEFAULT_DEPTH = _GCC.depth
DEFAULT_STEPS = _GCC.steps

# The reference's 19-column CSV schema (after the frame), verbatim.
CSV_HEADER = (
    "Frame,Quantization_Step,Rate_bpp,"
    "RAHT_prelude_time,RAHT_transform_time,Quant_time,"
    "Coeff_reorder_enc_time,Entropy_enc_time,"
    "Entropy_dec_time,Dequant_time,"
    "Coeff_reorder_dec_time,iRAHT_time,"
    "Total_enc_time,Total_dec_time,Pipeline_time,"
    "PSNR_all,PSNR_quats,PSNR_scales,PSNR_opacity,PSNR_colors"
)


@dataclass
class GsRDPoint:
    frame: int
    step: float
    bpp: float
    psnr: Dict[str, float]
    n_voxels: int
    stream_bytes: int
    times: dict = field(default_factory=dict)
    encoded: Optional[EncodedFrame] = None

    def csv_row(self) -> str:
        t = self.times
        enc = (t.get("RAHT_transform_time", 0.0) + t.get("Quant_time", 0.0)
               + t.get("Entropy_enc_time", 0.0))
        dec = (t.get("Entropy_dec_time", 0.0) + t.get("Dequant_time", 0.0)
               + t.get("Coeff_reorder_dec_time", 0.0) + t.get("iRAHT_time", 0.0))
        pipeline = t.get("RAHT_prelude_time", 0.0) + enc + dec
        return (
            f"{self.frame},{self.step:g},{self.bpp:.6f},"
            f"{t.get('RAHT_prelude_time', 0.0):.6f},"
            f"{t.get('RAHT_transform_time', 0.0):.6f},"
            f"{t.get('Quant_time', 0.0):.6f},"
            f"0.000000,"  # the encoder's reorder runs inside Quant: kept for the schema
            f"{t.get('Entropy_enc_time', 0.0):.6f},"
            f"{t.get('Entropy_dec_time', 0.0):.6f},"
            f"{t.get('Dequant_time', 0.0):.6f},"
            f"{t.get('Coeff_reorder_dec_time', 0.0):.6f},"
            f"{t.get('iRAHT_time', 0.0):.6f},"
            f"{enc:.6f},{dec:.6f},{pipeline:.6f},"
            f"{self.psnr['psnr_all']:.6f},{self.psnr['psnr_quats']:.6f},"
            f"{self.psnr['psnr_scales']:.6f},{self.psnr['psnr_opacity']:.6f},"
            f"{self.psnr['psnr_colors']:.6f}"
        )


@spanned("encode_gs_frame")
def encode_gs_frame(
    V_int: np.ndarray,
    attributes: np.ndarray,
    depth: int = DEFAULT_DEPTH,
    steps: Sequence[float] = DEFAULT_STEPS,
    group_step_scales: Optional[Dict[str, float]] = None,
    frame_index: int = 1,
    codec: Optional[AttributeCodec] = None,
    bucket: int = 1 << 13,
    dtype: torch.dtype = torch.float64,
    vmin: Optional[np.ndarray] = None,
    width: Optional[float] = None,
    keep_streams: bool = False,
    *,
    device: DeviceLike = None,
) -> List[GsRDPoint]:
    """RD sweep over a voxelized 3DGS payload, one GsRDPoint per step.

    ``attributes``: (N, 56) packed [quats, scales, opacity, colors].
    ``group_step_scales``: per-attribute-group multipliers of each step
    (per-attribute quantization); None = uniform steps. The transform runs
    once and serves every step (``encode_sweep``). Runs on the codec's
    device: CUDA unless ``device="cpu"`` (or a CPU codec)."""
    codec = codec or AttributeCodec(depth, dtype=dtype, device=device)
    if device is not None and not same_device(codec.device, resolve_device(device)):
        raise ValueError(f"codec runs on {codec.device}, not {device}")
    timer = StageTimer()
    t0 = time.perf_counter()
    frame = prepare_voxel_frame(
        V_int, np.asarray(attributes, dtype=np.float64), depth, bucket=bucket,
        dtype=dtype, vmin=vmin, width=width, device=codec.device,
    )
    timer.add("RAHT_prelude_time", time.perf_counter() - t0)

    if codec.predict:
        # the closed loop runs inside encode_sweep: no coefficients to hoist
        coeffs = order = None
    else:
        coeffs, order, _, timer = codec.transform(frame, timer)
    ref_sorted = to_host(frame.attributes[:frame.n_voxels])
    D = attributes.shape[1]
    step_vecs = [
        channel_steps(D, float(s), {k: float(s) * m for k, m in group_step_scales.items()})
        if group_step_scales else float(s)
        for s in steps
    ]
    points: List[GsRDPoint] = []
    sweep = codec.encode_sweep(frame, step_vecs, coeffs=coeffs, order=order)
    for step, enc in zip(steps, sweep):
        st = enc.timer
        for k, v in timer.stages.items():  # per-frame stages, shared by the steps
            st.add(k, v)
        rec, st = codec.decode(enc.stream, frame.codes, frame.weights, timer=st)
        points.append(GsRDPoint(
            frame=frame_index, step=float(step), bpp=enc.stream.bpp(),
            psnr=gs_group_psnr(ref_sorted, rec), n_voxels=frame.n_voxels,
            stream_bytes=enc.stream.payload_bytes, times=dict(st.stages),
            encoded=enc if keep_streams else None,
        ))
    return points
