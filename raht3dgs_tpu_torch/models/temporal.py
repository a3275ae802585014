"""Inter-frame sequence codec: I/P-frame coding of dynamic voxel sequences.

Counterpart of ``raht3dgs_tpu/models/temporal.py``, the same streams:

- **I-frames** (every ``gop``-th frame) use :class:`AttributeCodec`.
- **P-frames** predict each voxel's attributes from the previous frame's
  *reconstruction* by motion-compensated neighbour probes
  (``ops/temporal.py``), and code the residual with the same transform,
  quantizer and entropy coders. By default (container v3) the encoder
  searches a per-block motion field against the true residual and signals
  it (~3 near-zero RLGR symbols per occupied 16^3 block, charged to the
  rate); ``signal_motion=False`` writes the v2 stream, whose motion both
  sides derive from geometry.
- **Adaptive fallback**: with ``adaptive=True`` a P-frame that codes larger
  than its intra encoding ships as an I-frame.

The loop is closed: the encoder reconstructs every frame through the
decoder's own path (the same device ops and the same host casts), so its
reconstruction equals what :meth:`SequenceCodec.decode_frame` gives on the
same device, bit for bit.
"""

from __future__ import annotations

import struct
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from raht3dgs_tpu_torch.codec.bitstream import FrameStream
from raht3dgs_tpu_torch.codec.rlgr import rlgr_decode, rlgr_encode
from raht3dgs_tpu_torch.models.pipeline import AttributeCodec, VoxelFrame
from raht3dgs_tpu_torch.ops.morton import codes_to_host
from raht3dgs_tpu_torch.ops.temporal import (
    block_first,
    estimate_global_motion,
    predict_from_previous,
    refine_block_motion,
    search_block_motion,
)
from raht3dgs_tpu_torch.utils.timing import StageTimer

# the v3 container's motion section:
#   u8 block_side_log | u8 reserved | i32 global[3] | u32 n_blocks |
#   RLGR(signed) of 3*n_blocks per-block shifts relative to global,
#   xyz-interleaved in sorted-code block order
_MOTION_HEAD = struct.Struct("<BBiiiI")

# frames with fewer occupied voxels than this search exactly (stride 1):
# small blocks hold too few witnesses to subsample; larger frames take
# stride 4 (encoder-side only, the field is signalled)
_STRIDE_ADAPTIVE_MIN = 65536


def _pack_motion(codes_np, n_voxels, depth, bsl, global_mv, mv_np) -> bytes:
    """Serialize the block-constant motion field: row 0 of each occupied
    block (a top-code-bit run of the occupied prefix, whatever the pad
    bucket) carries the block's vector, coded relative to ``global_mv``."""
    bf = block_first(codes_np[:n_voxels], depth, bsl)
    sym = (mv_np[:n_voxels][bf] - global_mv[None, :]).astype(np.int64)
    payload, _ = rlgr_encode(sym.ravel(), signed=True)
    return _MOTION_HEAD.pack(bsl, 0, int(global_mv[0]), int(global_mv[1]),
                             int(global_mv[2]), sym.shape[0]) + payload


def signalled_global_motion(stream):
    """The global motion vector of a v3 inter stream's motion section, or
    None (an intra frame, a v2 derived-motion stream). The geometry coder
    compensates its temporal reference with it (profile 2)."""
    if (not getattr(stream, "inter", False) or stream.motion is None
            or len(stream.motion) < _MOTION_HEAD.size):
        return None
    _, _, gx, gy, gz, _ = _MOTION_HEAD.unpack(stream.motion[:_MOTION_HEAD.size])
    return np.array([gx, gy, gz], dtype=np.int64)


def _unpack_motion(motion: bytes, codes_np, n_voxels, n_padded, depth) -> np.ndarray:
    """The (n_padded, 3) int32 per-voxel motion field of a motion section."""
    if len(motion) < _MOTION_HEAD.size:
        raise ValueError("corrupt motion section: header cut off")
    bsl, _, gx, gy, gz, n_blocks = _MOTION_HEAD.unpack(motion[:_MOTION_HEAD.size])
    bf = block_first(codes_np[:n_voxels], depth, bsl)
    if int(bf.sum()) != n_blocks:
        raise ValueError(
            f"corrupt motion section: {n_blocks} blocks signalled but the "
            f"frame's codes form {int(bf.sum())} — positions do not match "
            "this stream"
        )
    sym, _ = rlgr_decode(motion[_MOTION_HEAD.size:], 3 * n_blocks, signed=True)
    sym = sym.reshape(n_blocks, 3)
    g = np.array([gx, gy, gz], np.int64)
    mv = np.broadcast_to(g, (n_padded, 3)).copy()
    mv[:n_voxels] = g[None, :] + sym[np.cumsum(bf) - 1]
    return mv.astype(np.int32)


def _residual_frame(frame: VoxelFrame, pred: torch.Tensor) -> VoxelFrame:
    """The frame whose attributes are the prediction residual (pad rows
    zero: their predictions are unmasked by contract)."""
    occ = (frame.weights > 0)[:, None]
    resid = torch.where(occ, frame.attributes - pred, torch.zeros_like(pred))
    return VoxelFrame(codes=frame.codes, attributes=resid, weights=frame.weights,
                      n_voxels=frame.n_voxels, depth=frame.depth, vmin=frame.vmin,
                      width=frame.width)


class SequenceCodec:
    """Encode/decode temporally coherent frame sequences with I/P frames.

    ``codec_kwargs`` go to :class:`AttributeCodec` (dtype, chunk, quant_mode,
    entropy, predict, device, ...): it runs on CUDA unless
    ``device="cpu"``, and every frame must lie on its device. Frames of
    differing voxel counts may have differing pad buckets (the predictor
    needs only sorted padded codes). ``predict=True`` composes: I-frames
    and P-frame residuals both run the predicted closed loop, whose decode
    replays the stream's recorded dtype."""

    def __init__(self, depth: int, gop: int = 8, adaptive: bool = True, probes: int = 27,
                 signal_motion: bool = True, block_side_log: int = 4,
                 search_iters: int = 2, search_stride: Optional[int] = None,
                 **codec_kwargs):
        if gop < 1:
            raise ValueError(f"gop must be >= 1, got {gop}")
        if probes not in (7, 27):
            raise ValueError(f"probes must be 7 or 27, got {probes}")
        if search_stride is not None and int(search_stride) < 1:
            raise ValueError(f"search_stride must be >= 1, got {search_stride}")
        if int(search_iters) < 1:
            raise ValueError(f"search_iters must be >= 1, got {search_iters}")
        self.depth = depth
        self.gop = int(gop)
        self.adaptive = bool(adaptive)
        self.probes = int(probes)
        self.signal_motion = bool(signal_motion)
        self.block_side_log = int(block_side_log)
        # encoder-side search reach (+-search_iters voxels around the global
        # vector) and witness stride; None = 1 below _STRIDE_ADAPTIVE_MIN
        # occupied voxels, 4 above. Only the signalled integers reach the
        # decoder, so both leave the stream format alone.
        self.search_iters = int(search_iters)
        self.search_stride = None if search_stride is None else int(search_stride)
        self.codec = AttributeCodec(depth, **codec_kwargs)
        self.reset()

    # -- shared helpers ---------------------------------------------------

    def _padded_recon(self, frame: VoxelFrame, rec: np.ndarray) -> torch.Tensor:
        """The reconstruction in the frame's slot layout (zeros in pads), in
        the codec's dtype on its device: the next frame's prediction source."""
        full = np.zeros((frame.codes.shape[0], rec.shape[1]), dtype=np.float64)
        full[:frame.n_voxels] = rec
        return torch.as_tensor(full, device=self.codec.device).to(self.codec.dtype)

    def _predict(self, frame: VoxelFrame, prev: Tuple, probes=None) -> torch.Tensor:
        """v2 prediction: global motion and its per-block refinement, both
        derived from the two frames' geometry (the decoder replays them)."""
        prev_frame, prev_recon = prev
        motion = estimate_global_motion(frame.codes, frame.weights, prev_frame.codes,
                                        prev_frame.weights, self.depth)
        motion = refine_block_motion(frame.codes, frame.weights, prev_frame.codes,
                                     prev_frame.weights, self.depth, motion)
        pred, _ = predict_from_previous(frame.codes, prev_frame.codes, prev_recon,
                                        prev_frame.weights, self.depth,
                                        probes or self.probes, motion)
        return pred

    def _effective_stride(self, n_voxels: int) -> int:
        """The witness stride for a frame: the explicit setting, or 1 below
        ``_STRIDE_ADAPTIVE_MIN`` occupied voxels and 4 above."""
        if self.search_stride is not None:
            return self.search_stride
        return 4 if n_voxels >= _STRIDE_ADAPTIVE_MIN else 1

    def _search(self, frame: VoxelFrame, prev: Tuple):
        """v3 encoder prediction: search the per-block field against the
        true residual and predict with it. Returns (pred, motion_bytes); the
        decoder rebuilds ``pred`` from ``motion_bytes`` alone."""
        prev_frame, prev_recon = prev
        motion = estimate_global_motion(frame.codes, frame.weights, prev_frame.codes,
                                        prev_frame.weights, self.depth)
        mv = search_block_motion(
            frame.codes, frame.attributes, frame.weights, prev_frame.codes, prev_recon,
            prev_frame.weights, self.depth, motion, block_side_log=self.block_side_log,
            iters=self.search_iters,
            stride=self._effective_stride(frame.n_voxels))
        motion_bytes = _pack_motion(codes_to_host(frame.codes, self.depth), frame.n_voxels,
                                    self.depth,
                                    self.block_side_log, motion.cpu().numpy().astype(np.int64),
                                    mv.cpu().numpy())
        pred, _ = predict_from_previous(frame.codes, prev_frame.codes, prev_recon,
                                        prev_frame.weights, self.depth, self.probes, mv)
        return pred, motion_bytes

    def _predict_signalled(self, frame: VoxelFrame, prev: Tuple,
                           stream: FrameStream) -> torch.Tensor:
        """v3 decoder prediction from the stream's motion section."""
        prev_frame, prev_recon = prev
        mv = _unpack_motion(stream.motion, codes_to_host(frame.codes, self.depth),
                            frame.n_voxels,
                            frame.codes.shape[0], self.depth)
        pred, _ = predict_from_previous(frame.codes, prev_frame.codes, prev_recon,
                                        prev_frame.weights, self.depth, stream.probes,
                                        torch.as_tensor(mv, device=frame.codes.device))
        return pred

    def _close_loop(self, frame: VoxelFrame, stream: FrameStream, pred,
                    timer: Optional[StageTimer]) -> np.ndarray:
        """Decode ``stream`` as the receiver will, add the prediction of an
        inter stream, and keep the result as the next frame's source."""
        rec, _ = self.codec.decode(stream, frame.codes, frame.weights, timer=timer)
        if stream.inter:
            rec = rec + pred.cpu().numpy()[:frame.n_voxels]
        self._prev = (frame, self._padded_recon(frame, rec))
        self._index += 1
        return rec

    def _force_intra(self) -> bool:
        return self._prev is None or self._index % self.gop == 0

    def _mark_inter(self, stream: FrameStream, motion_bytes) -> None:
        stream.inter = True
        stream.probes = self.probes
        stream.motion = motion_bytes

    # -- encode -----------------------------------------------------------

    def reset(self) -> None:
        """Drop the prediction state (start a new independent sequence)."""
        self._prev = None
        self._index = 0

    def encode_frame(self, frame: VoxelFrame, steps,
                     timer: Optional[StageTimer] = None) -> Tuple[FrameStream, np.ndarray]:
        """One frame in, (stream, decoder-exact reconstruction) out, the
        closed-loop state carried to the next call. ``timer`` receives the
        chosen candidate's stages only (with ``Predict_time`` when inter
        wins), so summed CSV stage columns count one encode a frame."""
        timer = timer if timer is not None else StageTimer()
        force_intra = self._force_intra()
        enc_intra = t_intra = None
        if force_intra or self.adaptive:
            t_intra = StageTimer()
            enc_intra = self.codec.encode(frame, steps, timer=t_intra)
        chosen, t_chosen = enc_intra, t_intra
        pred = None
        if not force_intra:
            t_inter = StageTimer()
            if self.signal_motion:
                pred, motion_bytes = t_inter.time("Predict_time", self._search, frame,
                                                  self._prev)
            else:
                pred = t_inter.time("Predict_time", self._predict, frame, self._prev)
                motion_bytes = None
            enc_inter = self.codec.encode(_residual_frame(frame, pred), steps, timer=t_inter)
            self._mark_inter(enc_inter.stream, motion_bytes)
            if (enc_intra is None
                    or enc_inter.stream.payload_bytes < enc_intra.stream.payload_bytes):
                chosen, t_chosen = enc_inter, t_inter
        for name, sec in t_chosen.stages.items():
            timer.add(name, sec)
        stream = chosen.stream
        return stream, self._close_loop(frame, stream, pred, timer)

    def encode_frame_target(self, frame: VoxelFrame, target_bpp: float,
                            timer: Optional[StageTimer] = None
                            ) -> Tuple[FrameStream, np.ndarray, float]:
        """Rate-targeted incremental encode: (stream, reconstruction, step).

        Each candidate (intra; inter when the GOP allows) searches its own
        step for the budget (``models/rd_search.py``; the inter budget less
        its motion bytes). The adaptive choice is the candidate with the
        finer step: at equal rate the smaller step has the lower distortion
        in either domain (orthonormal transform)."""
        from raht3dgs_tpu_torch.models.rd_search import search_step_for_bpp

        timer = timer if timer is not None else StageTimer()
        force_intra = self._force_intra()
        enc_intra = step_intra = None
        if force_intra or self.adaptive:
            t0 = time.perf_counter()
            r = search_step_for_bpp(frame, target_bpp, codec=self.codec)
            timer.add("Quant_time", time.perf_counter() - t0)
            enc_intra, step_intra = r.encoded, r.step
        chosen, step, pred = enc_intra, step_intra, None
        if not force_intra:
            t0 = time.perf_counter()
            if self.signal_motion:
                p, motion_bytes = self._search(frame, self._prev)
            else:
                p, motion_bytes = self._predict(frame, self._prev, probes=self.probes), None
            n = max(frame.n_voxels, 1)
            budget = target_bpp - (len(motion_bytes) * 8.0 / n if motion_bytes else 0.0)
            r2 = None
            if budget > 0:
                r2 = search_step_for_bpp(_residual_frame(frame, p), budget, codec=self.codec)
            timer.add("Predict_time", time.perf_counter() - t0)
            if r2 is not None:
                self._mark_inter(r2.encoded.stream, motion_bytes)
                if enc_intra is None or r2.step < step_intra:
                    chosen, step, pred = r2.encoded, r2.step, p
        if chosen is None:  # adaptive off and the motion ate the budget
            r = search_step_for_bpp(frame, target_bpp, codec=self.codec)
            chosen, step = r.encoded, r.step
        stream = chosen.stream
        return stream, self._close_loop(frame, stream, pred, timer), float(step)

    def encode_sequence(self, frames: Sequence[VoxelFrame], steps,
                        timers: Optional[List[StageTimer]] = None
                        ) -> Tuple[List[FrameStream], List[np.ndarray]]:
        """(streams, decoder-exact reconstructions), one per frame."""
        self.reset()
        streams, recons = [], []
        for frame in frames:
            timer = StageTimer()
            stream, rec = self.encode_frame(frame, steps, timer=timer)
            if timers is not None:
                timers.append(timer)
            streams.append(stream)
            recons.append(rec)
        return streams, recons

    # -- decode -----------------------------------------------------------

    def decode_frame(self, stream: FrameStream, frame: VoxelFrame) -> np.ndarray:
        """Incremental decode, the mirror of :meth:`encode_frame` (the same
        ``reset()``-managed prediction state)."""
        if stream.inter and self._prev is None:
            raise ValueError("inter stream without a preceding reconstructed frame")
        if stream.inter:
            is32 = self.codec.dtype == torch.float32
            if bool(stream.dtype32) != is32:
                raise ValueError(
                    "inter stream was encoded with "
                    f"{'float32' if stream.dtype32 else 'float64'} "
                    "transforms but this decoder runs "
                    f"{'float32' if is32 else 'float64'} — the closed "
                    "loop needs identical precision (pass the matching "
                    "dtype)"
                )
        pred = None
        if stream.inter:
            if stream.motion is not None:
                pred = self._predict_signalled(frame, self._prev, stream)
            else:
                pred = self._predict(frame, self._prev, probes=stream.probes)
        return self._close_loop(frame, stream, pred, None)

    def decode_sequence(self, streams: Sequence[FrameStream],
                        frames: Sequence[VoxelFrame]) -> List[np.ndarray]:
        """Mirror of :meth:`encode_sequence`; ``frames`` give each frame's
        (losslessly known) positions. The first stream must be intra."""
        self.reset()
        return [self.decode_frame(s, f) for s, f in zip(streams, frames)]
