"""The RAHT attribute codec pipeline: encode/decode one voxel frame.

Counterpart of ``raht3dgs_tpu/models/pipeline.py`` on its main path:
``prepare_voxel_frame`` -> span forward RAHT -> coefficient order ->
quantize and pads-last reorder on the device -> one ``.cpu()`` of the
(D, N) int32 symbol matrix -> host RLGR into an R3TC ``FrameStream``; and
back: RLGR -> upload -> structure pass and inverse order -> dequantize ->
span inverse RAHT.

Covered: ``impl="span"``, quantizers ``mid`` and ``deadzone``, orders
``ragft``, ``weight_desc`` and ``morton``, float32 and float64, and the
pipelined step sweep ``encode_sweep`` (pinned host buffers filled by a
fetch thread while the host entropy-codes the step before). Options of
the JAX package that later slices bring raise ``NotImplementedError``
naming their ROADMAP item. The wire-narrowing tiers of the JAX package
(built for a remote TPU link) are not ported: symbols cross as int32.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from raht3dgs_tpu_torch.codec.bitstream import FrameStream
from raht3dgs_tpu_torch.codec.rlgr import (
    _parse_chunk_header,
    rlgr_decode_channels,
    rlgr_encode_channels,
)
from raht3dgs_tpu_torch.ops.morton import code_dtype, morton_encode, pad_code
from raht3dgs_tpu_torch.ops.quantize import (
    dequantize,
    dequantize_biased,
    quantize,
    quantize_deadzone,
)
from raht3dgs_tpu_torch.ops.raht_span import (
    raht_forward_span,
    raht_inverse_span,
    raht_structure_span,
)
from raht3dgs_tpu_torch.ops.reorder import ORDER_MODES, coefficient_order
from raht3dgs_tpu_torch.utils.device import DeviceLike, resolve_device
from raht3dgs_tpu_torch.utils.padding import pad_rows, round_up_bucket
from raht3dgs_tpu_torch.utils.timing import StageTimer

_NP_CODE = {torch.int32: np.int32, torch.int64: np.int64}


@dataclass
class VoxelFrame:
    """A padded, Morton-sorted voxel frame on one device: real voxels in
    slots ``[0, n_voxels)``, invisible zero-weight padding after."""

    codes: torch.Tensor       # (Np,) int32 (J <= 10) or int64
    attributes: torch.Tensor  # (Np, D) float
    weights: torch.Tensor     # (Np,) float
    n_voxels: int
    depth: int
    vmin: np.ndarray
    width: float


@dataclass
class EncodedFrame:
    stream: FrameStream
    timer: StageTimer


def prepare_voxel_frame(
    positions: np.ndarray,
    attributes: np.ndarray,
    depth: int,
    bucket: int = 1 << 13,
    dtype: torch.dtype = torch.float64,
    vmin: Optional[np.ndarray] = None,
    width: Optional[float] = None,
    weights: Optional[np.ndarray] = None,
    *,
    device: DeviceLike = None,
) -> VoxelFrame:
    """Build a padded VoxelFrame from deduplicated integer voxel positions
    in ``[0, 2**depth)`` and their attributes; rows are Morton-sorted here.
    Runs on CUDA unless ``device="cpu"``."""
    dev = resolve_device(device)
    positions = np.asarray(positions)
    attributes = np.asarray(attributes)
    n = positions.shape[0]
    codes = morton_encode(
        torch.as_tensor(positions.astype(np.int64), device=dev), depth
    ).cpu().numpy()
    order = np.argsort(codes, kind="stable")
    codes = codes[order]
    if np.any(np.diff(codes) == 0):
        raise ValueError(
            "duplicate voxel positions — voxelize/deduplicate before encoding"
        )
    attributes = attributes[order]
    w = np.ones(n) if weights is None else np.asarray(weights, dtype=float)[order]

    n_padded = round_up_bucket(n, bucket)
    cdt = _NP_CODE[code_dtype(depth, n_padded)]
    pads = pad_code(depth, n_padded, torch.arange(n, n_padded)).numpy()
    codes_p = np.concatenate([codes.astype(cdt), pads.astype(cdt)])
    return VoxelFrame(
        codes=torch.as_tensor(codes_p, device=dev),
        attributes=torch.as_tensor(pad_rows(attributes.astype(np.float64), n_padded),
                                   device=dev).to(dtype),
        weights=torch.as_tensor(pad_rows(w, n_padded), device=dev).to(dtype),
        n_voxels=n,
        depth=depth,
        vmin=np.zeros(3) if vmin is None else np.asarray(vmin, dtype=float),
        width=float(2**depth) if width is None else float(width),
    )


def voxel_frame_from_arrays(codes, attributes, weights, n_voxels: int,
                            depth: int, vmin, width: float, *,
                            device: DeviceLike) -> VoxelFrame:
    """A VoxelFrame from padded numpy arrays (for example the JAX package's
    ``VoxelFrame`` fields), so both packages transform the same state. The
    float dtype is the attributes'."""
    dev = resolve_device(device)
    codes = np.array(codes)  # a writable copy: JAX buffers are read-only
    if codes.dtype == np.uint64:
        raise NotImplementedError(
            "uint64 codes (depth 21) are not ported yet (ROADMAP queue A, "
            "item 2: the J=21 tier)"
        )
    attrs = torch.as_tensor(np.array(attributes), device=dev)
    return VoxelFrame(
        codes=torch.as_tensor(codes, device=dev),
        attributes=attrs,
        weights=torch.as_tensor(np.array(weights), device=dev).to(attrs.dtype),
        n_voxels=int(n_voxels),
        depth=int(depth),
        vmin=np.asarray(vmin, dtype=float),
        width=float(width),
    )


def _transform_device(codes, attrs, weights, depth: int, order_mode: str = "ragft"):
    res = raht_forward_span(codes, attrs, weights, depth)
    if order_mode == "weight_desc":
        # the stream permutation is derived from the same structure function
        # the decoder runs, so encoder and decoder agree bit for bit
        order = coefficient_order(raht_structure_span(codes, weights, depth),
                                  order_mode)
    else:
        order = coefficient_order(res.structure, order_mode)
    return res.coeffs, order, res.structure


def _pads_last(order: torch.Tensor, nvox: int) -> torch.Tensor:
    """Reorder a coefficient permutation so padding slots land at the end
    (real relative order preserved)."""
    return order[torch.argsort((order >= nvox).to(torch.int8), stable=True)]


def _reorder_T_device(coeffs, order, nvox: int) -> torch.Tensor:
    """The pads-last stream permutation and the channel-major transpose:
    (D, N), so each channel's real stream is the contiguous prefix
    ``[:nvox]``. Quantization is elementwise and commutes with the
    permutation bitwise, so a sweep reorders once for all its steps."""
    return coeffs[_pads_last(order, nvox).long()].T.contiguous()


def _quant_T_device(coeffs_T, steps, quant_mode: str = "mid",
                    qf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize a reordered (D, N) coefficient matrix to int32 symbols
    (per-channel steps broadcast along D)."""
    st = steps[:, None] if steps.shape[0] > 1 else steps
    if quant_mode == "deadzone":
        return quantize_deadzone(coeffs_T, st, qf)
    return quantize(coeffs_T, st)


def _inverse_order_device(codes, weights, nvox: int, depth: int,
                          order_mode: str = "ragft") -> torch.Tensor:
    """Decoder prelude: inverse of the pads-last stream permutation."""
    structure = raht_structure_span(codes, weights, depth)
    order2 = _pads_last(coefficient_order(structure, order_mode), nvox)
    return torch.argsort(order2, stable=True).to(torch.int32)


def _dequant_gather_device(vals_T, inv, steps, dtype, quant_mode: str = "mid",
                           delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(D, N) stream-order symbols -> dequantized (N, D) coefficients back in
    transform position."""
    q = vals_T.T[inv.long()]
    if quant_mode == "deadzone":
        return dequantize_biased(q, steps, delta, dtype=dtype)
    return dequantize(q, steps, dtype=dtype)


def _inverse_device(coeffs, codes, weights, depth: int) -> torch.Tensor:
    return raht_inverse_span(coeffs, codes, weights, depth)


def encode_entropy_channels(q_np: np.ndarray, entropy: str, *, chunk: int, n: int):
    """Per-channel entropy encode; returns ``(channels, entropy_map, ns)``."""
    if entropy != "rlgr":
        raise NotImplementedError(
            f"entropy={entropy!r} is not ported yet (ROADMAP queue A, item 12)"
        )
    channels, enc_ns = rlgr_encode_channels(q_np, signed=True, channel_major=True,
                                            chunk=chunk, n=n)
    return channels, None, enc_ns


def decode_entropy_channels(stream: FrameStream, n: int, out: np.ndarray):
    """Decode the first ``n`` symbols of every channel into the rows of
    ``out``; returns ``(out, elapsed_ns)``."""
    if stream.entropy_map is not None and any(stream.entropy_map):
        raise NotImplementedError(
            "RAC channel payloads are not ported yet (ROADMAP queue A, item 12)"
        )
    return rlgr_decode_channels(stream.channels, n, signed=True, out=out,
                                chunk=stream.chunk)


def build_entropy_stream(q_np: np.ndarray, frame: VoxelFrame, steps, *, depth: int,
                         order_mode: str, chunk: int, quant_mode: str = "mid",
                         quant_f: float = 0.5, rec_delta: float = 0.0,
                         dtype32: bool = False, entropy: str = "rlgr"):
    """Host entropy-code one frame's (D, N) symbol matrix and wrap it as a
    FrameStream: the single place the stream is assembled. Returns
    ``(stream, encode_ns)``."""
    channels, emap, enc_ns = encode_entropy_channels(q_np, entropy, chunk=chunk,
                                                     n=frame.n_voxels)
    stream = FrameStream(
        depth=depth,
        n_voxels=frame.n_voxels,
        steps=np.atleast_1d(np.asarray(steps, dtype=np.float64)),
        channels=channels,
        vmin=frame.vmin,
        width=frame.width,
        order_mode=order_mode,
        chunk=chunk,
        quant_mode=quant_mode,
        quant_f=quant_f,
        rec_delta=rec_delta,
        dtype32=dtype32,
        entropy_map=emap,
    )
    return stream, enc_ns


def _fetched_symbols(qs: List[torch.Tensor], window: int = 2):
    """Yield each (D, N) int32 matrix of ``qs`` as a numpy view of a host
    buffer, with the seconds waited for it, in order.

    A fetch thread copies into ``window`` buffers, pinned for CUDA tensors
    (``non_blocking`` copies on the stream that ran the quantizes, each
    followed by an event the thread waits on); on the CPU the same loop
    copies synchronously. A buffer is refilled only after the consumer has
    asked for the next value, so it is never written while still read.
    A failure in the thread is raised here, after the thread has ended."""
    cuda = qs[0].device.type == "cuda"
    stream = torch.cuda.current_stream(qs[0].device) if cuda else None
    free: queue.Queue = queue.Queue()
    for _ in range(min(window, len(qs))):
        free.put(torch.empty(qs[0].shape, dtype=qs[0].dtype, pin_memory=cuda))
    ready: queue.Queue = queue.Queue()
    errs: list = []
    STOP = object()

    def fetcher():
        try:
            inflight: collections.deque = collections.deque()
            j = 0
            with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
                for _ in range(len(qs)):
                    # start copies while a buffer is free; wait for one only
                    # when no copy is in flight
                    while j < len(qs):
                        try:
                            buf = free.get(block=not inflight)
                        except queue.Empty:
                            break
                        if buf is STOP:
                            return
                        buf.copy_(qs[j], non_blocking=cuda)
                        ev = torch.cuda.Event() if cuda else None
                        if cuda:
                            ev.record(stream)
                        inflight.append((buf, ev))
                        j += 1
                    buf, ev = inflight.popleft()
                    if ev is not None:
                        ev.synchronize()
                    ready.put(buf)
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            errs.append(e)
            ready.put(STOP)

    th = threading.Thread(target=fetcher, daemon=True)
    th.start()
    try:
        for _ in range(len(qs)):
            t0 = time.perf_counter()
            buf = ready.get()
            if buf is STOP:
                break
            yield buf.numpy(), time.perf_counter() - t0
            free.put(buf)
    finally:
        free.put(STOP)  # wakes a fetcher that waits for a buffer
        th.join()
    if errs:
        raise errs[0]


class AttributeCodec:
    """Encode/decode attribute frames at a fixed octree depth on one device
    (CUDA unless ``device="cpu"``)."""

    def __init__(
        self,
        depth: int,
        dtype: torch.dtype = torch.float64,
        order_mode: str = "ragft",
        impl: Optional[str] = None,
        chunk: int = 0,
        quant_mode: str = "mid",
        quant_f: float = 0.3,
        rec_delta: float = 0.12,
        entropy: str = "rlgr",
        predict: bool = False,
        *,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        if order_mode not in ORDER_MODES:
            raise ValueError(f"unknown order mode {order_mode!r} (choose from {ORDER_MODES})")
        if quant_mode not in ("mid", "deadzone"):
            raise ValueError(f"unknown quant_mode {quant_mode!r}")
        if entropy not in ("rlgr", "rac", "auto"):
            raise ValueError(f"unknown entropy coder {entropy!r}")
        impl = impl or "span"
        if impl in ("dense", "compact", "scan", "golden"):
            raise NotImplementedError(
                f"impl={impl!r} is not ported yet (ROADMAP queue A, item 17)")
        if impl != "span":
            raise ValueError(f"unknown impl {impl!r}")
        if entropy != "rlgr":
            raise NotImplementedError(
                f"entropy={entropy!r} is not ported yet (ROADMAP queue A, item 12)")
        if predict:
            raise NotImplementedError(
                "predicted RAHT is not ported yet (ROADMAP queue A, item 13)")
        self.depth = depth
        self.dtype = dtype
        self.order_mode = order_mode
        self.impl = impl
        self.chunk = int(chunk)
        self.quant_mode = quant_mode
        self.quant_f = float(quant_f)
        self.rec_delta = float(rec_delta)
        self.entropy = entropy

    def _on_device(self, x) -> torch.Tensor:
        t = torch.as_tensor(x)
        if t.device.type != self.device.type:
            raise ValueError(f"tensor on {t.device}, codec runs on {self.device}")
        return t

    def _scalar(self, value) -> torch.Tensor:
        return torch.as_tensor(value, dtype=self.dtype, device=self.device)

    # -- encoding ---------------------------------------------------------

    def transform(self, frame: VoxelFrame, timer: Optional[StageTimer] = None):
        """Forward RAHT + coefficient order. Returns (coeffs, order, structure, timer)."""
        timer = timer or StageTimer()
        coeffs, order, structure = timer.time(
            "RAHT_transform_time", _transform_device,
            self._on_device(frame.codes), frame.attributes, frame.weights,
            self.depth, self.order_mode,
        )
        return coeffs, order, structure, timer

    def encode(self, frame: VoxelFrame, steps, coeffs=None, order=None,
               timer: Optional[StageTimer] = None) -> EncodedFrame:
        """Full encode: transform (unless given), quantize, reorder, one
        device-to-host copy of the symbols (timed with Quant_time), RLGR."""
        timer = timer or StageTimer()
        if coeffs is None or order is None:
            coeffs, order, _, timer = self.transform(frame, timer)
        q_np = timer.time("Quant_time", lambda: self._quantize(
            _reorder_T_device(coeffs, order, frame.n_voxels), steps).cpu().numpy())
        return self._entropy_frame(q_np, frame, steps, timer)

    def encode_sweep(self, frame: VoxelFrame, steps_list, coeffs=None,
                     order=None) -> List[EncodedFrame]:
        """Pipelined quantization-step sweep, byte-identical to
        ``[self.encode(frame, s, coeffs, order) for s in steps_list]``.

        The transform (unless given) and the reorder run once; every step's
        quantize is queued up front. A fetch thread copies the symbols of
        each step into one of two host buffers (pinned on the card) and
        hands them over in order; this thread runs RLGR on each, so step
        k's entropy coding overlaps step k+1's copy. Per-step
        ``Quant_time`` is the wait for that step's symbols (on the card the
        quantize itself runs ahead of it)."""
        steps_list = list(steps_list)
        if not steps_list:
            return []
        if coeffs is None or order is None:
            coeffs, order, _, _ = self.transform(frame)
        coeffs_T = _reorder_T_device(coeffs, order, frame.n_voxels)
        qs = [self._quantize(coeffs_T, s) for s in steps_list]
        out: List[EncodedFrame] = []
        with contextlib.closing(_fetched_symbols(qs)) as fetched:
            for s, (q_np, wait_s) in zip(steps_list, fetched):
                timer = StageTimer()
                timer.add("Quant_time", wait_s)
                out.append(self._entropy_frame(q_np, frame, s, timer))
        return out

    def _quantize(self, coeffs_T: torch.Tensor, steps) -> torch.Tensor:
        steps_t = torch.atleast_1d(self._scalar(np.asarray(steps, dtype=np.float64)))
        return _quant_T_device(coeffs_T, steps_t, self.quant_mode,
                               self._scalar(self.quant_f))

    def _entropy_frame(self, q_np: np.ndarray, frame: VoxelFrame, steps,
                       timer: StageTimer) -> EncodedFrame:
        """RLGR-code one step's (D, N) symbols into its FrameStream."""
        stream, enc_ns = build_entropy_stream(
            q_np, frame, steps, depth=self.depth, order_mode=self.order_mode,
            chunk=self.chunk, quant_mode=self.quant_mode, quant_f=self.quant_f,
            rec_delta=self.rec_delta, dtype32=self.dtype == torch.float32,
            entropy=self.entropy,
        )
        timer.add("Entropy_enc_time", enc_ns / 1e9)
        return EncodedFrame(stream=stream, timer=timer)

    # -- decoding ---------------------------------------------------------

    def decode(self, stream: FrameStream, codes, weights,
               timer: Optional[StageTimer] = None) -> Tuple[np.ndarray, StageTimer]:
        """Decode a stream given the (losslessly known) padded voxel codes and
        weights the encoder used; returns (n_voxels, D) attributes."""
        return self.decode_progressive(stream, codes, weights, stream.n_voxels,
                                       timer=timer)

    def decode_progressive(self, stream: FrameStream, codes, weights, n_coeffs: int,
                           timer: Optional[StageTimer] = None
                           ) -> Tuple[np.ndarray, StageTimer]:
        """Decode only the first ``n_coeffs`` stream symbols per channel; the
        rest reconstruct as zero detail coefficients (a coarse preview in
        both structure-ordered stream orders)."""
        timer = timer or StageTimer()
        codes = self._on_device(codes)
        weights = self._on_device(weights)
        n_padded = codes.shape[0]
        nvox = stream.n_voxels
        D = stream.n_channels
        k = int(min(max(n_coeffs, 1), nvox))
        if nvox > n_padded:
            raise ValueError(
                f"stream encodes {nvox} voxels but the provided positions "
                f"only cover {n_padded} padded slots — positions do not "
                "match this stream"
            )
        if stream.predict:
            raise NotImplementedError(
                "predicted-RAHT streams are not ported yet (ROADMAP queue A, item 13)")
        inv = timer.time("Coeff_reorder_dec_time", _inverse_order_device, codes,
                         weights, nvox, self.depth, stream.order_mode)
        # zeros beyond the decoded prefix ARE the truncated coefficients
        vals_T = np.zeros((D, n_padded), dtype=np.int32)
        _, dec_ns = decode_entropy_channels(stream, k, vals_T)
        timer.add("Entropy_dec_time", dec_ns / 1e9)
        steps = self._scalar(stream.steps if stream.steps.shape[0] > 1
                             else stream.steps[0])
        coeffs = timer.time(
            "Dequant_time",
            lambda: _dequant_gather_device(
                torch.from_numpy(vals_T).to(self.device), inv, steps, self.dtype,
                stream.quant_mode, self._scalar(stream.rec_delta)),
        )
        attrs = timer.time("iRAHT_time", _inverse_device, coeffs, codes, weights,
                           self.depth)
        return attrs.cpu().numpy()[:nvox], timer


def progressive_prefix_bytes(stream: FrameStream, n_coeffs: int) -> int:
    """Entropy bytes a receiver needs for ``decode_progressive(n_coeffs)``:
    exact for chunked streams (the header plus every chunk overlapping
    ``[0, n_coeffs)``); sequential streams report their full channels."""
    k = int(min(max(n_coeffs, 1), stream.n_voxels))
    total = 0
    for s in stream.channels:
        if stream.chunk > 0:
            c, lens, off = _parse_chunk_header(s)
            total += off + sum(lens[:-(-k // c)])
        else:
            total += len(s)
    return total
