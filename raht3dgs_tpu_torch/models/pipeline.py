"""The RAHT attribute codec pipeline: encode/decode one voxel frame.

Counterpart of ``raht3dgs_tpu/models/pipeline.py`` on its main path:
``prepare_voxel_frame`` -> span forward RAHT -> coefficient order ->
quantize and pads-last reorder on the device -> one ``.cpu()`` of the
(D, N) int32 symbol matrix -> host RLGR (or RAC) into an R3TC
``FrameStream``; and back: entropy decode -> upload -> structure pass and inverse order -> dequantize ->
span inverse RAHT.

Covered: ``impl="span"``, quantizers ``mid`` and ``deadzone``, orders
``ragft``, ``weight_desc`` and ``morton``, float32 and float64, and the
pipelined step sweep ``encode_sweep`` (pinned host buffers filled by a
fetch thread while the host entropy-codes the step before), the
level-of-detail decode ``decode_lod``, with the
entropy coders ``rlgr``, ``rac`` and ``auto``, and inter-depth predicted
RAHT (``predict=True``: the device encoder ``ops/praht_device.py`` on the
card, the frozen host closed loop ``ops/praht.py`` on the CPU or when
asked, and the host loop for every decode of a predicted stream). Options
of the JAX package that later slices bring raise ``NotImplementedError``
naming their ROADMAP item. The codec's own decode uploads its symbols as
int32; the serving path (``models/serving.py``) uploads them through the
narrowing tiers ``pack_quantized_upload`` / ``upload_quantized``.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from raht3dgs_tpu_torch.codec.bitstream import FrameStream
from raht3dgs_tpu_torch.codec.rac import (
    rac_decode,
    rac_decode_channels,
    rac_decode_chunked,
    rac_encode,
    rac_encode_channels,
    rac_encode_chunked,
    rac_stream_profile,
)
from raht3dgs_tpu_torch.codec.rlgr import (
    _parse_chunk_header,
    rlgr_decode,
    rlgr_decode_channels,
    rlgr_decode_chunked,
    rlgr_encode_channels,
)
from raht3dgs_tpu_torch.ops.morton import code_dtype, morton_encode, pad_code
from raht3dgs_tpu_torch.ops.praht import (
    _decode_axes_np,
    praht_decode,
    praht_encode,
    praht_plan,
    praht_true_coeffs,
)
from raht3dgs_tpu_torch.ops.praht_device import (
    MAX_DEPTH as PRAHT_DEVICE_MAX_DEPTH,
    praht_device_encode,
    praht_device_plan,
)
from raht3dgs_tpu_torch.ops.quantize import (
    dequantize,
    dequantize_biased,
    quantize,
    quantize_deadzone,
)
from raht3dgs_tpu_torch.ops.raht import ieee_sqrt
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


def _scale_sqrt_w(attributes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``attrs * sqrt(w)``: the predicted loop's true coefficients are the
    standard forward transform of this scaled input (the identity for the
    common unit-weight voxelized case); see ops/praht_device.py."""
    return attributes * ieee_sqrt(weights.to(attributes.dtype))[:, None]


def encode_entropy_channels(q_np: np.ndarray, entropy: str, *, chunk: int, n: int):
    """Per-channel entropy encode under the selected coder; returns
    ``(channels, entropy_map_or_None, elapsed_ns)``.

    ``rlgr``: the reference coder (no entropy map, pre-v5 bytes). ``rac``:
    every channel RAC. ``auto``: per channel the smallest of RLGR, RAC and,
    for channels > 0, RAC conditioned on channel 0's significance (profile
    1; the decoder derives the same bits from its decoded channel 0,
    whichever coder that channel used); the v5 entropy map records the
    choice, and is left out when every channel chose RLGR."""
    if entropy == "rlgr":
        channels, enc_ns = rlgr_encode_channels(q_np, signed=True, channel_major=True,
                                                chunk=chunk, n=n)
        return channels, None, enc_ns
    if entropy == "rac":
        channels, enc_ns = rac_encode_channels(q_np, channel_major=True, chunk=chunk, n=n)
        return channels, (True,) * len(channels), enc_ns
    if entropy != "auto":
        raise ValueError(f"unknown entropy coder {entropy!r}")
    rl, ns1 = rlgr_encode_channels(q_np, signed=True, channel_major=True, chunk=chunk, n=n)
    ra, ns2 = rac_encode_channels(q_np, channel_major=True, chunk=chunk, n=n)
    D = q_np.shape[0]
    cond = np.ascontiguousarray(q_np[0, :n] != 0, dtype=np.uint8)
    t0 = time.perf_counter_ns()
    rows = np.ascontiguousarray(q_np[:, :n], dtype=np.int32)
    if chunk > 0:
        rc = [None] + [rac_encode_chunked(rows[d], chunk, cond=cond)[0] for d in range(1, D)]
    else:
        rc = [None] + [rac_encode(rows[d], cond=cond)[0] for d in range(1, D)]
    ns3 = time.perf_counter_ns() - t0
    channels, emap = [], []
    for d in range(D):
        cands = [(rl[d], False), (ra[d], True)]
        if rc[d] is not None:
            cands.append((rc[d], True))
        best = min(cands, key=lambda c: len(c[0]))
        channels.append(best[0])
        emap.append(best[1])
    emap = tuple(emap)
    return channels, (emap if any(emap) else None), ns1 + ns2 + ns3


def decode_entropy_channels(stream: FrameStream, n: int, out: np.ndarray):
    """Decode the first ``n`` symbols of every channel payload into the
    rows of ``out``, per channel as the stream's entropy map says (absent
    or False: RLGR; True: RAC, whose leading profile byte selects plain (0)
    or channel-0-conditioned (1) contexts: channel 0 decodes first and its
    significance conditions the profile-1 channels). Returns
    ``(out, elapsed_ns)``."""
    emap = stream.entropy_map
    if emap is None or not any(emap):
        return rlgr_decode_channels(stream.channels, n, signed=True, out=out,
                                    chunk=stream.chunk)
    profiles = [rac_stream_profile(stream.channels[d], stream.chunk) if is_rac else -1
                for d, is_rac in enumerate(emap)]
    if emap[0] and profiles[0] == 1:
        raise ValueError(
            "corrupt stream: channel 0 cannot use the cross-channel profile "
            "(it is the conditioning source)"
        )
    if all(emap) and 1 not in profiles:
        return rac_decode_channels(stream.channels, n, out, chunk=stream.chunk,
                                   n_total=stream.n_voxels)
    t0 = time.perf_counter_ns()
    cond = None

    def _one(d):
        payload = stream.channels[d]
        if emap[d]:
            kw = {"cond": cond} if profiles[d] == 1 else {}
            if stream.chunk > 0:
                rac_decode_chunked(payload, n, stream.n_voxels, out=out[d, :n], **kw)
            else:
                rac_decode(payload, n, stream.n_voxels, out=out[d, :n], **kw)
        elif stream.chunk > 0:
            rlgr_decode_chunked(payload, n, signed=True, out=out[d])
        else:
            rlgr_decode(payload, n, signed=True, out=out[d])

    _one(0)
    if 1 in profiles:
        cond = np.ascontiguousarray(out[0, :n] != 0, dtype=np.uint8)
    for d in range(1, len(emap)):
        _one(d)
    return out, time.perf_counter_ns() - t0


def quantized_upload_array(vals_T: np.ndarray) -> np.ndarray:
    """Narrow the (D, N) int32 quantized channel matrix to int16 when every
    value fits (half the upload bytes); consumers widen back before
    dequantization, so results are bitwise unchanged."""
    if vals_T.dtype == np.int32 and np.abs(vals_T, dtype=np.int64).max(initial=0) < (1 << 15):
        return vals_T.astype(np.int16)
    return vals_T


class QuantizedUpload(NamedTuple):
    """Host-side packing of a quantized channel matrix for upload.

    Dense tiers: ``vals`` is the matrix, narrowed to int8/int16 where that
    pays; the few entries that overflow the narrow dtype are truncated in
    ``vals`` and carried exactly by the flat-index patch ``(patch_idx,
    patch_val)`` (empty arrays when none is needed).

    Sparse tier (``shape`` set): a mostly-zero matrix (inter residuals,
    coarse steps) travels as ``(patch_idx, vals)``, the flat indices of its
    nonzeros and their values in the narrowest exact dtype; the device
    scatters them into zeros. Chosen by :func:`pack_quantized_upload` only
    when its padded bytes beat the best dense tier;
    ``RAHT3DGS_UPLOAD_SPARSE=0`` turns it off."""

    vals: np.ndarray
    patch_idx: np.ndarray
    patch_val: np.ndarray
    shape: tuple = None


_EMPTY_I32 = np.zeros((0,), np.int32)


def _upload_patch_enabled() -> bool:
    return os.environ.get("RAHT3DGS_UPLOAD_PATCH", "1") not in ("0", "false", "")


def _upload_sparse_enabled() -> bool:
    return os.environ.get("RAHT3DGS_UPLOAD_SPARSE", "1") not in ("0", "false", "")


def _sparse_upload(vals_T: np.ndarray, nz: np.ndarray, dense_bytes: int):
    """The sparse tier when its (padded) indices and values beat the best
    dense tier, else ``None``. Values take the narrowest dtype holding every
    nonzero exactly; the count pads to a power-of-two bucket with copies of
    entry 0 (the same index and value written again)."""
    val = vals_T.reshape(-1)[nz]
    a = np.abs(val, dtype=np.int64)
    vmax = int(a.max()) if val.size else 0
    if vmax < 128:
        vdt = np.int8
    elif vmax < (1 << 15):
        vdt = np.int16
    else:
        vdt = np.int32
    bucket = 64
    while bucket < nz.size:
        bucket *= 2
    if bucket * (4 + np.dtype(vdt).itemsize) >= dense_bytes:
        return None
    pad = bucket - nz.size
    if pad:
        fi = nz[0] if nz.size else np.int32(0)
        fv = val[0] if val.size else 0
        nz = np.concatenate([nz, np.full(pad, fi, np.int32)])
        val = np.concatenate([val, np.full(pad, fv, val.dtype)])
    return QuantizedUpload(val.astype(vdt), nz, _EMPTY_I32, tuple(vals_T.shape))


def _padded_patch(vals_narrow: np.ndarray, over: np.ndarray,
                  flat: np.ndarray) -> QuantizedUpload:
    """The overflow patch (index, exact value), padded to a power-of-two
    bucket with copies of entry 0 (identical writes)."""
    val = flat[over]
    bucket = 8
    while bucket < over.size:
        bucket *= 2
    pad = bucket - over.size
    idx = np.concatenate([over, np.full(pad, over[0], np.int32)])
    val = np.concatenate([val, np.full(pad, val[0], np.int32)])
    return QuantizedUpload(vals_narrow, idx, val)


def pack_quantized_upload(vals_T: np.ndarray) -> QuantizedUpload:
    """Narrow an int32 quantized matrix to int8/int16 even when a handful of
    entries overflow, carrying the overflows as an exact patch; or, for a
    mostly-zero matrix, its nonzeros alone.

    Patch policy: int16 + patch while the patch (8 bytes an entry) costs at
    most half the 2 bytes an entry that int16 saves against int32 (``P <=
    size // 8``); int8 + patch while it costs at most half the byte an entry
    that int8 saves against int16 (``P <= size // 16``).
    ``RAHT3DGS_UPLOAD_PATCH=0`` restores the all-or-nothing int16/int32
    choice. The JAX package's choice, array for array."""
    if vals_T.dtype != np.int32:
        return QuantizedUpload(vals_T, _EMPTY_I32, _EMPTY_I32)
    flat = vals_T.reshape(-1)
    a = np.abs(flat, dtype=np.int64)
    over8 = np.flatnonzero(a >= 128).astype(np.int32)
    patch_ok = _upload_patch_enabled()
    if over8.size == 0:
        dense = QuantizedUpload(vals_T.astype(np.int8), _EMPTY_I32, _EMPTY_I32)
    elif patch_ok and over8.size <= flat.size // 16:
        dense = _padded_patch(vals_T.astype(np.int8), over8, flat)
    else:
        over16 = over8[a[over8] >= (1 << 15)]  # a subset of over8
        if over16.size == 0:
            dense = QuantizedUpload(vals_T.astype(np.int16), _EMPTY_I32, _EMPTY_I32)
        elif not patch_ok or over16.size > flat.size // 8:
            dense = QuantizedUpload(vals_T, _EMPTY_I32, _EMPTY_I32)
        else:
            dense = _padded_patch(vals_T.astype(np.int16), over16, flat)
    if _upload_sparse_enabled():
        dense_bytes = dense.vals.nbytes + dense.patch_idx.nbytes + dense.patch_val.nbytes
        nnz = int(np.count_nonzero(flat))
        if nnz * 5 < dense_bytes:  # a cheap test before flatnonzero
            sp = _sparse_upload(vals_T, np.flatnonzero(flat).astype(np.int32), dense_bytes)
            if sp is not None:
                return sp
    return dense


def upload_quantized(up: QuantizedUpload, *, device: DeviceLike = None) -> torch.Tensor:
    """Move a :class:`QuantizedUpload` to the device (CUDA unless
    ``device="cpu"``). A dense tier with a patch widens to int32 and writes
    the patch; the sparse tier writes its nonzeros into zeros. Returns a
    tensor that, widened to int32, is bitwise the original matrix: int8 or
    int16 when that is exact, else int32. Padding entries rewrite entry 0's
    own index and value, so the order of duplicate writes is immaterial."""
    dev = resolve_device(device)
    if up.shape is not None:
        val = torch.as_tensor(up.vals).to(dev)
        flat = torch.zeros(int(np.prod(up.shape)), dtype=val.dtype, device=dev)
        flat[torch.as_tensor(up.patch_idx).to(dev).long()] = val
        return flat.reshape(up.shape)
    vals = torch.as_tensor(up.vals).to(dev)
    if up.patch_idx.size == 0:
        return vals
    flat = vals.to(torch.int32).reshape(-1)
    flat[torch.as_tensor(up.patch_idx).to(dev).long()] = torch.as_tensor(up.patch_val).to(dev)
    return flat.reshape(vals.shape)


def build_entropy_stream(q_np: np.ndarray, frame: VoxelFrame, steps, *, depth: int,
                         order_mode: str, chunk: int, quant_mode: str = "mid",
                         quant_f: float = 0.5, rec_delta: float = 0.0,
                         dtype32: bool = False, entropy: str = "rlgr",
                         predict: bool = False, predict_mask: int = 0):
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
        predict=predict,
        predict_mask=predict_mask,
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
        predict_impl: str = "auto",
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
        # Inter-depth predicted RAHT (ops/praht.py): residuals against an
        # upsampled prediction in the same stream layout. Decode is
        # flag-driven (any codec decodes a predicted stream, always through
        # the frozen host loop), so `predict` only steers the encoder.
        if predict and order_mode != "ragft":
            raise ValueError(
                "predict=True needs the RA-GFT coefficient order (the depth "
                f"groups must be stream-sequential), got {order_mode!r}")
        # the predicted encoder: "host" (the frozen closed loop), "device"
        # (ops/praht_device.py, the same stream format) or "auto" (device on
        # the card for depth <= 20, host on the CPU)
        if predict_impl not in ("host", "device", "auto"):
            raise ValueError(
                f"unknown predict_impl {predict_impl!r} (choose host, device or auto)")
        if predict_impl == "device" and depth > PRAHT_DEVICE_MAX_DEPTH:
            raise ValueError(
                "predict_impl='device' covers the int32/int64 code tiers "
                f"(depth <= {PRAHT_DEVICE_MAX_DEPTH}), got depth={depth}; use 'host'")
        self.depth = depth
        self.dtype = dtype
        self.order_mode = order_mode
        self.impl = impl
        self.chunk = int(chunk)
        self.quant_mode = quant_mode
        self.quant_f = float(quant_f)
        self.rec_delta = float(rec_delta)
        self.entropy = entropy
        self.predict = bool(predict)
        self.predict_impl = predict_impl
        # step-independent predicted-loop state, shared across a sweep's
        # steps and decodes: host plans and true coefficients keyed by
        # content hash, device (coeffs, order, plan) keyed by the frame's
        # tensors (each entry pins its frame, so an id is never reused)
        self._praht_plans: dict = {}
        self._praht_tcs: dict = {}
        self._praht_dev_cache: dict = {}

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
        device-to-host copy of the symbols (timed with Quant_time), host
        entropy coding."""
        timer = timer or StageTimer()
        if self.predict:
            if self._predict_on_device():
                return self._praht_encode_device(frame, steps, timer)
            return self._praht_encode(frame, steps, timer)
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
        hands them over in order; this thread entropy-codes each, so step
        k's entropy coding overlaps step k+1's copy. Per-step
        ``Quant_time`` is the wait for that step's symbols (on the card the
        quantize itself runs ahead of it). A predicted codec ignores
        ``coeffs`` and ``order``: every step is its own closed loop."""
        steps_list = list(steps_list)
        if not steps_list:
            return []
        if self.predict:
            if self._predict_on_device():
                return self._praht_sweep_device(frame, steps_list)
            # the step-independent plan and true coefficients come from the
            # per-frame cache (_praht_context): the first step builds them
            return [self.encode(frame, s) for s in steps_list]
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
                       timer: StageTimer,
                       predict_mask: Optional[int] = None) -> EncodedFrame:
        """Entropy-code one step's (D, N) symbols into its FrameStream (a
        predicted one when ``predict_mask`` is given)."""
        stream, enc_ns = build_entropy_stream(
            q_np, frame, steps, depth=self.depth, order_mode=self.order_mode,
            chunk=self.chunk, quant_mode=self.quant_mode, quant_f=self.quant_f,
            rec_delta=self.rec_delta, dtype32=self.dtype == torch.float32,
            entropy=self.entropy, predict=predict_mask is not None,
            predict_mask=predict_mask or 0,
        )
        timer.add("Entropy_enc_time", enc_ns / 1e9)
        return EncodedFrame(stream=stream, timer=timer)

    # -- predicted RAHT (ops/praht.py, ops/praht_device.py) ----------------

    def _praht_fdtype(self, stream: Optional[FrameStream] = None):
        """The predicted loop's numpy dtype: decode replays the encoder's
        recorded precision (the closed loop depends on it), encode uses the
        codec's own."""
        dtype32 = stream.dtype32 if stream is not None else self.dtype == torch.float32
        return np.float32 if dtype32 else np.float64

    def _praht_context(self, codes_np: np.ndarray, w_np: np.ndarray, fdtype,
                       attrs_np: Optional[np.ndarray] = None):
        """(plan, true coefficients or None) of one frame's real rows, cached
        by content hash (a sweep re-enters per step; the praht call checks
        the plan against the codes, so a collision cannot decode the wrong
        stream)."""
        gkey = (codes_np.shape[0], self.depth, np.dtype(fdtype).name,
                hashlib.sha1(np.ascontiguousarray(codes_np).tobytes()).hexdigest(),
                hashlib.sha1(np.ascontiguousarray(w_np).tobytes()).hexdigest())
        plan = self._praht_plans.get(gkey)
        if plan is None:
            plan = praht_plan(codes_np, w_np, self.depth, fdtype=fdtype)
            while len(self._praht_plans) >= 2:
                self._praht_plans.pop(next(iter(self._praht_plans)))
            self._praht_plans[gkey] = plan
        if attrs_np is None:
            return plan, None
        tkey = gkey + (hashlib.sha1(np.ascontiguousarray(attrs_np).tobytes()).hexdigest(),)
        tc = self._praht_tcs.get(tkey)
        if tc is None:
            tc = praht_true_coeffs(plan, attrs_np)
            while len(self._praht_tcs) >= 4:
                self._praht_tcs.pop(next(iter(self._praht_tcs)))
            self._praht_tcs[tkey] = tc
        return plan, tc

    def _praht_encode(self, frame: VoxelFrame, steps, timer: StageTimer) -> EncodedFrame:
        """Host closed-loop predicted-RAHT encode (ops/praht.py); the plan
        and the true coefficients come from the per-frame cache."""
        n = frame.n_voxels
        codes_np = self._on_device(frame.codes).cpu().numpy()[:n]
        attrs_np = frame.attributes.cpu().numpy()[:n]
        w_np = frame.weights.cpu().numpy()[:n]
        fdtype = self._praht_fdtype()

        def _run():
            plan, tc = self._praht_context(codes_np, w_np, fdtype, attrs_np)
            return praht_encode(
                codes_np, attrs_np, w_np, self.depth,
                np.atleast_1d(np.asarray(steps, dtype=np.float64)),
                quant_mode=self.quant_mode, quant_f=self.quant_f,
                rec_delta=self.rec_delta, fdtype=fdtype, plan=plan, true_coeffs=tc)

        sym_T, mask, _ = timer.time("RAHT_transform_time", _run)
        return self._entropy_frame(sym_T, frame, steps, timer, predict_mask=mask)

    def _predict_on_device(self) -> bool:
        """The device encoder for "device", and for "auto" on the card at
        depth <= 20; the frozen host loop otherwise. Decode is host either
        way."""
        if self.predict_impl == "auto":
            return self.device.type == "cuda" and self.depth <= PRAHT_DEVICE_MAX_DEPTH
        return self.predict_impl == "device"

    def _praht_dev_context(self, frame: VoxelFrame):
        """(true coefficients, RA-GFT order, device plan) of one frame,
        cached by the identity of its tensors (the entry pins the frame)."""
        key = (id(frame.codes), id(frame.weights), id(frame.attributes))
        ent = self._praht_dev_cache.get(key)
        if ent is None:
            codes = self._on_device(frame.codes)
            coeffs, order, structure = _transform_device(
                codes, _scale_sqrt_w(frame.attributes, frame.weights), frame.weights,
                self.depth, "ragft")
            plan = praht_device_plan(codes, frame.weights, self.depth,
                                     structure.drop_level, structure.subtree_w)
            while len(self._praht_dev_cache) >= 2:
                self._praht_dev_cache.pop(next(iter(self._praht_dev_cache)))
            ent = (frame, coeffs, order, plan)
            self._praht_dev_cache[key] = ent
        return ent[1], ent[2], ent[3]

    def praht_device_step(self, frame: VoxelFrame, steps):
        """One step's device closed loop, queued on the device: ``(q_T (D,
        Np) int32 stream-order symbols, predict mask device scalar, rec
        (Np, D) the encoder's own reconstruction)``. Nothing crosses to the
        host."""
        coeffs, order, plan = self._praht_dev_context(frame)
        steps_t = torch.atleast_1d(self._scalar(np.asarray(steps, dtype=np.float64)))
        sym, maskbits, rec = praht_device_encode(
            plan, frame.codes, frame.weights, coeffs, self.depth, steps_t,
            quant_mode=self.quant_mode, qf=self.quant_f, rec_delta=self.rec_delta)
        return _reorder_T_device(sym, order, frame.n_voxels), maskbits, rec

    def _praht_encode_device(self, frame: VoxelFrame, steps,
                             timer: StageTimer) -> EncodedFrame:
        """Device predicted-RAHT encode: the host encoder's stream format
        (see ops/praht_device.py on why encoder-side float drift cannot
        break it); one copy of the symbols, then the mask."""
        q_T, maskbits, _ = timer.time("RAHT_transform_time", self.praht_device_step,
                                      frame, steps)
        q_np, mask = timer.time("Quant_time", lambda: (q_T.cpu().numpy(), int(maskbits)))
        return self._entropy_frame(q_np, frame, steps, timer, predict_mask=mask)

    def _praht_sweep_device(self, frame: VoxelFrame, steps_list) -> List[EncodedFrame]:
        """Device predicted sweep: every step's closed loop queued up front
        (the plan shared), the symbols drained through the fetch thread of
        :meth:`encode_sweep` while this thread entropy-codes the step
        before; byte-identical to per-step :meth:`encode`."""
        pend = [self.praht_device_step(frame, s)[:2] for s in steps_list]
        out: List[EncodedFrame] = []
        with contextlib.closing(_fetched_symbols([q for q, _ in pend])) as fetched:
            for s, (_, maskbits), (q_np, wait_s) in zip(steps_list, pend, fetched):
                timer = StageTimer()
                timer.add("Quant_time", wait_s)
                out.append(self._entropy_frame(q_np, frame, s, timer,
                                               predict_mask=int(maskbits)))
        return out

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
            return self._praht_decode(stream, codes, weights, k, timer)
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

    def _praht_decode(self, stream: FrameStream, codes, weights, k: int,
                      timer: StageTimer, lod_depth: Optional[int] = None):
        """Host decode of a predicted-RAHT stream (flag-driven: any codec
        decodes one; the loop replays the encoder's recorded dtype). Symbols
        past the ``k``-prefix stay zero residuals, so a cut stream
        reconstructs as the prediction cascade; ``lod_depth`` stops the
        descent there (``praht_decode``). Codes and weights cross to the
        host once; the plan comes from the per-frame cache."""
        if stream.order_mode != "ragft":
            raise ValueError(
                "corrupt stream: predicted transform requires the RA-GFT "
                f"coefficient order, stream has {stream.order_mode!r}")
        nvox = stream.n_voxels
        vals_T = np.zeros((stream.n_channels, nvox), dtype=np.int32)
        _, dec_ns = decode_entropy_channels(stream, k, vals_T)
        timer.add("Entropy_dec_time", dec_ns / 1e9)
        codes_np = codes.cpu().numpy()[:nvox]
        w_np = weights.cpu().numpy()[:nvox]
        fdtype = self._praht_fdtype(stream)

        def _run():
            plan, _ = self._praht_context(codes_np, w_np, fdtype)
            return praht_decode(
                vals_T, codes_np, w_np, self.depth,
                stream.steps if stream.steps.shape[0] > 1 else stream.steps[0],
                predict_mask=stream.predict_mask, quant_mode=stream.quant_mode,
                quant_f=stream.quant_f, rec_delta=stream.rec_delta, fdtype=fdtype,
                lod_depth=lod_depth, plan=plan)

        return timer.time("iRAHT_time", _run), timer

    def decode_lod(self, stream: FrameStream, codes, weights, lod_depth: int,
                   timer: Optional[StageTimer] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Level-of-detail decode: the frame at octree depth ``lod_depth``.

        Decodes exactly the stream prefix holding the coefficients above the
        level-``lod_depth`` cells (:func:`lod_prefix_count`: in the RA-GFT
        order that cut is a prefix), reconstructs, and collapses each cell to
        one row, sampled at its first leaf (for unit leaf weights the
        truncated reconstruction is constant over a cell and equals its mean
        attributes). A predicted stream's host loop stops at the cut depth
        and yields the cell means directly.

        Returns ``(positions_int (M, 3) at depth lod_depth, attrs (M, D),
        cell_weights (M,))``."""
        if stream.order_mode != "ragft":
            raise ValueError(
                "decode_lod needs the RA-GFT coefficient order (stream has "
                f"{stream.order_mode!r}) — only there is a depth cut a "
                "stream prefix")
        timer = timer or StageTimer()
        codes = self._on_device(codes)
        weights = self._on_device(weights)
        nvox = stream.n_voxels
        codes_np = codes.cpu().numpy()[:nvox]
        k = lod_prefix_count(codes_np, self.depth, lod_depth)
        if stream.predict:
            if nvox > codes.shape[0]:
                raise ValueError(
                    f"stream encodes {nvox} voxels but the provided positions "
                    f"only cover {codes.shape[0]} padded slots — positions do "
                    "not match this stream")
            (cell_codes, means, cell_w), timer = self._praht_decode(
                stream, codes, weights, k, timer, lod_depth=lod_depth)
            return _decode_axes_np(cell_codes, lod_depth), means, cell_w
        rec, timer = self.decode_progressive(stream, codes, weights, k, timer=timer)
        shift = 3 * (self.depth - lod_depth)
        coarse = codes_np.astype(np.int64) >> shift
        firsts = np.concatenate([[True], coarse[1:] != coarse[:-1]])
        idx = np.nonzero(firsts)[0]
        cell_w = np.add.reduceat(weights.cpu().numpy()[:nvox].astype(np.float64), idx)
        return _decode_axes_np(coarse[idx], lod_depth), rec[idx], cell_w


def _msb_np(x: np.ndarray) -> np.ndarray:
    """Index of the most significant set bit of each ``x > 0``."""
    x = x.astype(np.uint64)
    b = np.zeros(x.shape, np.int32)
    for s in (32, 16, 8, 4, 2, 1):
        big = x >= (np.uint64(1) << np.uint64(s))
        b += big.astype(np.int32) * s
        x = np.where(big, x >> np.uint64(s), x)
    return b


def lod_prefix_count(codes_np: np.ndarray, depth: int, lod_depth: int) -> int:
    """Stream symbols covering an LOD cut at octree depth ``lod_depth``.

    The RA-GFT order groups detail coefficients by octree depth, coarsest
    first, so the DC plus every detail of a merge above the level-``L``
    cells (merge bit level > 3*(depth-L)) is a stream prefix. ``codes_np``
    are the frame's real (unpadded) sorted unique Morton codes."""
    if not 1 <= lod_depth <= depth:
        raise ValueError(f"lod_depth must be in [1, {depth}], got {lod_depth}")
    codes_np = np.asarray(codes_np)
    if len(codes_np) <= 1:
        return 1
    drop = _msb_np(codes_np[1:] ^ codes_np[:-1]) + 1  # merge level of each detail
    group = -(-drop // 3)
    return 1 + int(np.sum(group >= depth - lod_depth + 1))


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
