"""Double-single (hi, lo) compensated prefix sums: the CUDA kernel and its
plain PyTorch version.

Counterpart of ``raht3dgs_tpu/ops/pallas_scan.py`` (``ds_cumsum_pallas``
and ``ds_cumsum_pallas_t``). The kernel is ``csrc/ds_scan.cu``, with two
entries: one matrix, and a (B, N, K) stack of frames (the TPU kernel under
``jax.vmap``). It is built with nvcc for ``sm_90a`` into ``_build/`` at
first use and called through ctypes on PyTorch's current stream of the
tensor's device, with that device made current for the launch (the
kernel's shared-memory opt-in is per device). The
wrappers take the plain version only for a tensor that lies on the CPU;
for a CUDA tensor they launch the kernel or raise. :func:`ds_prefix_pack`
gives the codec's prefix pack (a zero row, then ``[hi | lo]``), which on
the card the kernel writes itself. Both take any number of columns K in
one call: up to 8 columns a block scans a whole tile; wider rows (the 3DGS
transform's (N, 57) pack, the Gaussian merge's (N, 60) sums) take the wide
path of ``csrc/ds_scan.cu``, column blocks of 8 whose blocks of one tile
run side by side, each staging its slice with ``cp.async`` and scanning
it from shared memory at two blocks an SM, with the same adds per column.
``scripts/scan_phase_probe.py`` splits the wide path's time on the card.
:func:`ds_cumsum_batched` and :func:`ds_prefix_pack_batched` scan every
frame of a stack in the launches one frame takes; frame b's result is the
single entry's on ``x[b]``, bit for bit.

Both the kernel and :func:`ds_cumsum_reference` keep ~48 mantissa bits
(error-free two-sum) and give exact results for integer-valued lanes whose
partial sums stay below 2^24 — under their own association, which differs
between the two, so float lanes agree to ~1e-12 relative, not bitwise.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from raht3dgs_tpu_torch.codec._native import NativeLib, nvcc_command

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc", "ds_scan.cu",
)


def _configure(lib: ctypes.CDLL) -> None:
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ds_cumsum_f32.argtypes = [vp, ll, i32, ll, ll, i32, vp, vp, ll, vp]
    lib.ds_cumsum_f32.restype = i32
    lib.ds_cumsum_batched_f32.argtypes = [vp, ll, ll, i32, i32, vp, vp, ll, vp]
    lib.ds_cumsum_batched_f32.restype = i32


KERNEL = NativeLib(_SRC, "libds_scan.so", _configure, nvcc_command)

TILE = 2048             # rows per block (kTile in csrc/ds_scan.cu)
MAX_CARRY_TILES = 2048  # tile totals one block combines (kMaxCarryTiles)
MAX_FRAMES = 65535      # frames of one batched launch (the grid's z extent)


def scratch_floats(n: int, k: int) -> int:
    """Floats of scratch the kernel needs for ``n`` rows of ``k`` columns:
    the tile totals (hi, lo), and beyond ``MAX_CARRY_TILES`` tiles also
    their scan and the next level's scratch. The kernel counts the same
    (``scratch_need``) and refuses to launch with less."""
    t = -(-n // TILE)
    if t <= 1:
        return 0
    if t <= MAX_CARRY_TILES:
        return 2 * t * k
    return 4 * t * k + scratch_floats(t, k)


# Kernel launches per entry point. Each wrapper adds one where it launches
# the kernel and nowhere else; callers reset and read them.
LAUNCHES = {"ds_cumsum": 0, "ds_cumsum_t": 0, "ds_cumsum_batched": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- plain version ------------------------------------------------------------


def _ds_add(h1, l1, h2, l2):
    """(h1, l1) + (h2, l2) in double-single, one IEEE op per line."""
    s = h1 + h2
    bv = s - h1
    err = (h1 - (s - bv)) + (h2 - bv)
    e = err + (l1 + l2)
    hi = s + e
    lo = e - (hi - s)
    return hi, lo


def _ds_scan_plain(hi, lo, block: int = 256):
    """Inclusive ds scan along dim 0 of an (N, K) (hi, lo) pair: a sequential
    scan inside ``block``-row blocks (vectorized over blocks), the same scan
    applied to the block totals, and one combine."""
    N, K = hi.shape
    if N <= block:
        out_h = torch.empty_like(hi)
        out_l = torch.empty_like(lo)
        rh = torch.zeros(K, dtype=hi.dtype, device=hi.device)
        rl = torch.zeros_like(rh)
        for i in range(N):
            rh, rl = _ds_add(rh, rl, hi[i], lo[i])
            out_h[i] = rh
            out_l[i] = rl
        return out_h, out_l
    nb = -(-N // block)
    pad = torch.zeros(nb * block - N, K, dtype=hi.dtype, device=hi.device)
    vh = torch.cat([hi, pad]).reshape(nb, block, K)
    vl = torch.cat([lo, pad]).reshape(nb, block, K)
    oh = torch.empty_like(vh)
    ol = torch.empty_like(vl)
    rh = torch.zeros(nb, K, dtype=hi.dtype, device=hi.device)
    rl = torch.zeros_like(rh)
    for j in range(block):
        rh, rl = _ds_add(rh, rl, vh[:, j], vl[:, j])
        oh[:, j] = rh
        ol[:, j] = rl
    ch, cl = _ds_scan_plain(oh[:, -1], ol[:, -1], block)
    zrow = torch.zeros(1, K, dtype=hi.dtype, device=hi.device)
    ch = torch.cat([zrow, ch[:-1]])[:, None]
    cl = torch.cat([zrow, cl[:-1]])[:, None]
    oh, ol = _ds_add(ch, cl, oh, ol)
    return oh.reshape(nb * block, K)[:N], ol.reshape(nb * block, K)[:N]


def ds_cumsum_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`ds_cumsum` on any device."""
    _check(x)
    return _ds_scan_plain(x, torch.zeros_like(x))


def ds_prefix_pack_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`ds_prefix_pack` on any device."""
    hi, lo = ds_cumsum_reference(x)
    P = torch.cat([hi, lo], dim=1)
    return torch.cat([P.new_zeros((1, P.shape[1])), P])


def ds_cumsum_batched_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`ds_cumsum_batched` on any device:
    every frame's columns side by side in one (N, B*K) plain scan, whose
    adds are per column, so frame b's result is
    ``ds_cumsum_reference(x[b])`` bit for bit."""
    _check_batched(x)
    B, N, K = x.shape
    cols = x.permute(1, 0, 2).reshape(N, B * K)
    hi, lo = _ds_scan_plain(cols, torch.zeros_like(cols))
    return tuple(t.reshape(N, B, K).permute(1, 0, 2).contiguous() for t in (hi, lo))


def ds_prefix_pack_batched_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`ds_prefix_pack_batched`."""
    hi, lo = ds_cumsum_batched_reference(x)
    P = torch.cat([hi, lo], dim=2)
    return torch.cat([P.new_zeros((P.shape[0], 1, P.shape[2])), P], dim=1)


# -- kernel wrappers ------------------------------------------------------------


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"ds scan takes float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"ds scan takes a 2-D tensor, got shape {tuple(x.shape)}")


def _check_batched(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"ds scan takes float32, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"batched ds scan takes a (B, N, K) tensor, got shape "
                         f"{tuple(x.shape)}")


def _launch(x: torch.Tensor, n: int, k: int, rs: int, cs: int, entry: str,
            pack: bool = False):
    """Launch the kernel on ``x`` (element (r, c) at ``x[r*rs + c*cs]``).

    Returns ``(hi, lo)`` in ``x``'s layout, or with ``pack`` the
    ``(n+1, 2k)`` matrix ``[0; hi | lo]`` written by the kernel itself. One
    allocation holds the outputs and the kernel's scratch. The launch runs
    with ``x``'s device current, on that device's current stream: the
    kernel's shared-memory opt-in binds to the current device."""
    if k < 1:
        raise ValueError(f"ds scan kernel takes at least one column, got {k}")
    if not x.is_contiguous():
        raise ValueError("ds scan kernel takes a contiguous tensor")
    if x.device.type != "cuda":
        raise ValueError(f"ds scan kernel needs a CUDA tensor, got {x.device}")
    if x.get_device() != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _launch(x, n, k, rs, cs, entry, pack)
    lib = KERNEL.load()
    if n == 0:
        if pack:
            return x.new_zeros((1, 2 * k))
        return x.new_empty(x.shape), x.new_empty(x.shape)
    # one allocation: the outputs' rows, then rows enough for the scratch
    rows, width = (n + 1, 2 * k) if pack else (2 * x.shape[0], x.shape[1])
    buf = x.new_empty((rows + -(-scratch_floats(n, k) // width), width))
    out = buf.data_ptr()
    # the raw handle of PyTorch's current stream (torch.cuda.current_stream
    # builds a Stream object first, ~5 us a call)
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    rc = lib.ds_cumsum_f32(x.data_ptr(), n, k, rs, cs, int(pack), out,
                           out + 4 * rows * width, buf.numel() - rows * width,
                           stream)
    if rc != 0:
        raise RuntimeError(f"ds_cumsum_f32 launch failed (code {rc})")
    LAUNCHES[entry] += 1
    if pack:
        return buf[:rows]
    hi, lo, *_ = buf.split(x.shape[0])
    return hi, lo


def _row_entry(k: int) -> str:
    # a single column is the same memory in both layouts and counts as the
    # transposed entry, which the decoder's one-column scans are
    return "ds_cumsum_t" if k == 1 else "ds_cumsum"


def ds_cumsum(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compensated inclusive prefix sums along dim 0 of ``x (N, K)`` f32.

    Returns ``(hi, lo)`` float32 (N, K)."""
    _check(x)
    if x.device.type == "cpu":
        return ds_cumsum_reference(x)
    N, K = x.shape
    return _launch(x, N, K, K, 1, _row_entry(K))


def ds_cumsum_t(xt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transposed entry: ``xt (K, N)`` f32, scanned along the last axis;
    returns ``(hi, lo)`` in the same (K, N) layout."""
    _check(xt)
    if xt.device.type == "cpu":
        hi, lo = ds_cumsum_reference(xt.T)
        return hi.T.contiguous(), lo.T.contiguous()
    K, N = xt.shape
    return _launch(xt, N, K, 1, N, "ds_cumsum_t")


def ds_prefix_pack(x: torch.Tensor) -> torch.Tensor:
    """``x (N, K)`` f32 -> ``(N+1, 2K)``: a zero row, then :func:`ds_cumsum`'s
    ``[hi | lo]``. On a CUDA tensor the kernel writes the pack itself."""
    _check(x)
    if x.device.type == "cpu":
        return ds_prefix_pack_reference(x)
    N, K = x.shape
    return _launch(x, N, K, K, 1, _row_entry(K), pack=True)


def _launch_batched(x: torch.Tensor, pack: bool):
    """Launch the batched entry on the (B, N, K) stack ``x``: ``(hi, lo)``
    as (B, N, K) views of one (B, 2, N, K) block, or with ``pack`` the
    (B, N + 1, 2K) stack of packs. One allocation holds the outputs and
    every frame's scratch. Runs with ``x``'s device current, as
    :func:`_launch` does."""
    B, N, K = x.shape
    if K < 1:
        raise ValueError(f"ds scan kernel takes at least one column, got {K}")
    if not x.is_contiguous():
        raise ValueError("ds scan kernel takes a contiguous tensor")
    if x.device.type != "cuda":
        raise ValueError(f"ds scan kernel needs a CUDA tensor, got {x.device}")
    if B > MAX_FRAMES:
        raise ValueError(f"batched ds scan takes at most {MAX_FRAMES} frames, got {B}")
    if x.get_device() != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _launch_batched(x, pack)
    lib = KERNEL.load()
    if B == 0 or N == 0:
        if pack:
            return x.new_zeros((B, N + 1, 2 * K))
        return x.new_empty(x.shape), x.new_empty(x.shape)
    per = (N + 1) * 2 * K if pack else 2 * N * K
    scratch = B * scratch_floats(N, K)
    buf = x.new_empty(B * per + scratch)
    out = buf.data_ptr()
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    rc = lib.ds_cumsum_batched_f32(x.data_ptr(), B, N, K, int(pack), out,
                                   out + 4 * B * per, scratch, stream)
    if rc != 0:
        raise RuntimeError(f"ds_cumsum_batched_f32 launch failed (code {rc})")
    LAUNCHES["ds_cumsum_batched"] += 1
    if pack:
        return buf[:B * per].view(B, N + 1, 2 * K)
    hl = buf[:B * per].view(B, 2, N, K)
    return hl[:, 0], hl[:, 1]


def ds_cumsum_batched(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ds_cumsum` of every frame of ``x (B, N, K)`` f32, in one
    launch per pass of the kernel. Returns ``(hi, lo)``, each (B, N, K)."""
    _check_batched(x)
    if x.device.type == "cpu":
        return ds_cumsum_batched_reference(x)
    return _launch_batched(x, pack=False)


def ds_prefix_pack_batched(x: torch.Tensor) -> torch.Tensor:
    """:func:`ds_prefix_pack` of every frame of ``x (B, N, K)`` f32: the
    (B, N + 1, 2K) stack of packs, written by the kernel on the card."""
    _check_batched(x)
    if x.device.type == "cpu":
        return ds_prefix_pack_batched_reference(x)
    return _launch_batched(x, pack=True)
