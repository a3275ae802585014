"""Batched multi-frame codec: encode/decode a stack of frames per call.

Counterpart of ``raht3dgs_tpu/models/batch_codec.py`` on one device. The
reference's dataset sweep runs one frame at a time; here frames are padded
to one shared bucket, stacked into (B, N, D) and transformed together
(``parallel/sharding.py``): the scan kernel's batched entry runs every
frame's prefix sums in one launch per pass. Each frame's stream is the
bytes of a per-frame :meth:`AttributeCodec.encode`, and its decode the
per-frame decode.

Symbols cross to the host as int32 through the pinned-buffer fetch thread
of ``AttributeCodec.encode_sweep`` (the JAX package's wire-narrowing tiers,
built for a remote TPU link, are not ported). Every entropy choice
(``rlgr``, ``rac``, ``auto``) goes through ``build_entropy_stream``. A
``mesh`` (ROADMAP queue A, item 18) and ``predict=True`` (item 13) raise,
naming their item.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from raht3dgs_tpu_torch.codec.bitstream import FrameStream
from raht3dgs_tpu_torch.models.pipeline import (
    AttributeCodec,
    VoxelFrame,
    _fetched_symbols,
    build_entropy_stream,
    decode_entropy_channels,
    prepare_voxel_frame,
)
from raht3dgs_tpu_torch.parallel.sharding import (
    batched_decode_step,
    batched_forward,
    batched_inverse_order,
    batched_quant_reorder,
    batched_quant_T,
    batched_reorder_T,
)
from raht3dgs_tpu_torch.utils.device import DeviceLike, resolve_device
from raht3dgs_tpu_torch.utils.padding import round_up_bucket
from raht3dgs_tpu_torch.utils.timing import StageTimer


def prepare_frame_batch(
    positions_list: Sequence[np.ndarray],
    attributes_list: Sequence[np.ndarray],
    depth: int,
    bucket: int = 1 << 13,
    dtype: torch.dtype = torch.float64,
    *,
    device: DeviceLike = None,
) -> List[VoxelFrame]:
    """Prepare frames padded to one shared bucketed size, on CUDA unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    n_max = max(p.shape[0] for p in positions_list)
    shared = round_up_bucket(n_max, bucket)
    return [
        prepare_voxel_frame(p, a, depth, bucket=shared, dtype=dtype, device=dev)
        for p, a in zip(positions_list, attributes_list)
    ]


class BatchAttributeCodec:
    """Encode/decode stacks of equally bucketed frames on one device (CUDA
    unless ``device="cpu"``)."""

    def __init__(
        self,
        depth: int,
        dtype: torch.dtype = torch.float64,
        order_mode: str = "ragft",
        mesh=None,
        chunk: int = 0,
        quant_mode: str = "mid",
        quant_f: float = 0.3,
        rec_delta: float = 0.12,
        entropy: str = "rlgr",
        predict: bool = False,
        *,
        device: DeviceLike = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported yet (ROADMAP queue A, item 18)")
        # the single-frame codec checks the options (refusing the unported
        # ones by item) and assembles every stream
        self._codec = AttributeCodec(
            depth, dtype=dtype, order_mode=order_mode, chunk=chunk,
            quant_mode=quant_mode, quant_f=quant_f, rec_delta=rec_delta,
            entropy=entropy, predict=predict, device=device)
        self.device = self._codec.device
        self.depth = depth
        self.dtype = dtype
        self.order_mode = order_mode

    def _stack(self, frames: Sequence[VoxelFrame]):
        if not frames:
            raise ValueError("an empty frame batch")
        if len({tuple(f.codes.shape) for f in frames}) != 1:
            raise ValueError("batched frames must share one padded size "
                             "(prepare_frame_batch)")
        on = self._codec._on_device
        return (torch.stack([on(f.codes) for f in frames]),
                torch.stack([on(f.attributes) for f in frames]),
                torch.stack([on(f.weights) for f in frames]))

    def _nvox(self, frames: Sequence[VoxelFrame]) -> torch.Tensor:
        return torch.tensor([f.n_voxels for f in frames], dtype=torch.int32,
                            device=self.device)

    def _steps(self, steps) -> torch.Tensor:
        return torch.atleast_1d(self._codec._scalar(np.asarray(steps, dtype=np.float64)))

    def transform(self, frames: Sequence[VoxelFrame],
                  timer: Optional[StageTimer] = None):
        """Step-independent half of the encode (forward RAHT + stream
        order) for the whole batch: ``(coeffs, orderp, timer)``."""
        timer = timer or StageTimer()
        codes, attrs, weights = self._stack(frames)
        coeffs, orderp = timer.time(
            "RAHT_transform_time", batched_forward,
            codes, attrs, weights, self.depth, self.order_mode, self._nvox(frames))
        return coeffs, orderp, timer

    def encode(self, frames: Sequence[VoxelFrame], steps, coeffs=None, orderp=None,
               timer: Optional[StageTimer] = None) -> Tuple[List[FrameStream], StageTimer]:
        """One stream per frame at ``steps``; the transform unless given."""
        timer = timer or StageTimer()
        if coeffs is None or orderp is None:
            coeffs, orderp, timer = self.transform(frames, timer)
        q_np = timer.time("Quant_time", lambda: batched_quant_reorder(
            coeffs, self._steps(steps), orderp, self._codec.quant_mode,
            self._codec._scalar(self._codec.quant_f)).cpu().numpy())
        streams, enc_ns = self._entropy_streams(q_np, frames, steps)
        timer.add("Entropy_enc_time", enc_ns / 1e9)
        return streams, timer

    def _entropy_streams(self, q_np: np.ndarray, frames: Sequence[VoxelFrame], steps):
        """Per-frame host entropy over a fetched (B, D, N) symbol stack,
        assembled as the single-frame codec assembles a stream."""
        c = self._codec
        streams: List[FrameStream] = []
        enc_ns = 0
        for q, f in zip(q_np, frames):
            stream, ns = build_entropy_stream(
                q, f, steps, depth=self.depth, order_mode=self.order_mode,
                chunk=c.chunk, quant_mode=c.quant_mode, quant_f=c.quant_f,
                rec_delta=c.rec_delta, dtype32=self.dtype == torch.float32,
                entropy=c.entropy)
            enc_ns += ns
            streams.append(stream)
        return streams, enc_ns

    def encode_sweep(self, frames: Sequence[VoxelFrame], steps_list: Sequence,
                     coeffs=None, orderp=None
                     ) -> List[Tuple[List[FrameStream], StageTimer]]:
        """Pipelined step sweep, byte-identical to ``[self.encode(frames, s,
        coeffs, orderp) for s in steps_list]``: one reorder for every step,
        every step's quantize queued up front, and the fetch thread of
        ``AttributeCodec.encode_sweep`` copying each step's (B, D, N)
        symbols into pinned buffers while this thread RLGR-codes the step
        before. Per-step ``Quant_time`` is the wait for that step's
        symbols."""
        steps_list = list(steps_list)
        if not steps_list:
            return []
        if coeffs is None or orderp is None:
            coeffs, orderp, _ = self.transform(frames)
        coeffs_T = batched_reorder_T(coeffs, orderp)
        qf = self._codec._scalar(self._codec.quant_f)
        qs = [batched_quant_T(coeffs_T, self._steps(s), self._codec.quant_mode, qf)
              for s in steps_list]
        out: List[Tuple[List[FrameStream], StageTimer]] = []
        with contextlib.closing(_fetched_symbols(qs)) as fetched:
            for s, (q_np, wait_s) in zip(steps_list, fetched):
                timer = StageTimer()
                timer.add("Quant_time", wait_s)
                streams, enc_ns = self._entropy_streams(q_np, frames, s)
                timer.add("Entropy_enc_time", enc_ns / 1e9)
                out.append((streams, timer))
        return out

    def inverse_order(self, frames: Sequence[VoxelFrame], order_mode=None):
        """Step-independent decode-side stream->transform permutation,
        reusable across a sweep (``decode(..., inv=...)``)."""
        codes, _, weights = self._stack(frames)
        return batched_inverse_order(codes, weights, self._nvox(frames), self.depth,
                                     order_mode or self.order_mode)

    def decode(self, streams: Sequence[FrameStream], frames: Sequence[VoxelFrame],
               timer: Optional[StageTimer] = None, inv=None
               ) -> Tuple[List[np.ndarray], StageTimer]:
        """Decode a batch; frames supply the (losslessly known) positions.
        ``inv``: an :meth:`inverse_order` result to reuse across a sweep."""
        timer = timer or StageTimer()
        for s in streams:
            if s.inter:
                raise ValueError(
                    "inter (predicted) streams hold residuals — decode "
                    "them through SequenceCodec (models/temporal.py), "
                    "which chains the predictions"
                )
        if any(s.predict for s in streams):
            if not all(s.predict for s in streams):
                raise ValueError(
                    "batched decode requires a homogeneous transform mode "
                    "— these streams mix predicted and plain RAHT; decode "
                    "them frame by frame (AttributeCodec.decode)"
                )
            raise NotImplementedError(
                "predicted-RAHT streams are not ported yet (ROADMAP queue A, item 13)")
        # one step vector and one order mode dequantize the whole stack:
        # mixed-parameter streams would reconstruct with the wrong steps
        for s in streams[1:]:
            if (
                not np.array_equal(s.steps, streams[0].steps)
                or s.order_mode != streams[0].order_mode
                or s.quant_mode != streams[0].quant_mode
                or s.rec_delta != streams[0].rec_delta
            ):
                raise ValueError(
                    "batched decode requires homogeneous steps/order_mode/"
                    "quantizer across streams — decode mixed streams frame "
                    "by frame (AttributeCodec.decode)"
                )
        codes, _, weights = self._stack(frames)
        if inv is None:
            inv = timer.time("Coeff_reorder_dec_time", batched_inverse_order,
                             codes, weights, self._nvox(frames), self.depth,
                             streams[0].order_mode)
        else:
            timer.add("Coeff_reorder_dec_time", 0.0)

        B, N = codes.shape
        D = streams[0].n_channels
        qfull = np.zeros((B, D, N), dtype=np.int32)
        dec_ns = 0
        for i, s in enumerate(streams):
            _, ns = decode_entropy_channels(s, s.n_voxels, qfull[i])
            dec_ns += ns
        timer.add("Entropy_dec_time", dec_ns / 1e9)

        s0 = streams[0]
        steps = self._codec._scalar(s0.steps if s0.steps.shape[0] > 1 else s0.steps[0])
        rec = timer.time(
            "iRAHT_time", lambda: batched_decode_step(
                codes, weights, torch.from_numpy(qfull).to(self.device), inv, steps,
                self.depth, self.dtype, s0.quant_mode,
                self._codec._scalar(s0.rec_delta)).cpu().numpy())
        return [rec[i][: f.n_voxels] for i, f in enumerate(frames)], timer
