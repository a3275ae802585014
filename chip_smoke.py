#!/usr/bin/env python3
"""Drive the PyTorch port (``raht3dgs_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line, any failure exits nonzero:

1. device and build: the card, torch/CUDA versions, and the seconds nvcc
   (the scan kernel) and g++ (the RLGR, RAC, geometry and predicted-RAHT
   host coders) took,
   built in parallel from the checkout's sources;
2. kernels against their plain PyTorch version on the card, at the main
   path's shapes (the forward's (2^19, 4) scan through ``ds_prefix_pack``,
   as the transform calls it), timed twice: the wrapper as the main path
   calls it (CUDA events around one call, median of 100) and the device's
   own time and kernel launches per call (profiler, 50 back-to-back
   calls); then the kernel's scratch count, and the scan's bitwise
   invariants on fractional data (a column alone == the same column in a
   pack, row entry == transposed entry, run == run, kernel-written prefix
   pack == the concatenation of hi and lo under a zero row) and edge sizes
   (1 row, one tile -1 and +1, and 2^23 + 3 rows, past the one-block
   carry);
3. the main path at full width: 500k unique voxels, J=10, D=3, bucket
   2^19, float32, step 16, through ``prepare_voxel_frame`` ->
   ``AttributeCodec.encode`` -> container bytes -> ``decode``, with the
   kernels' launch counts read around one encode + decode; then a J=18
   frame (int64 codes) through the same path;
4. the golden fixture encoded at float64 on the card must reproduce the
   port's CPU stream hash;
5. the voxelizer: a seeded raw cloud of 2 000 000 float32 points on
   jittered sphere shells (``utils/synth.py:raw_surface_cloud``) voxelized
   at J=10 on the card, held against the same call on the CPU (integer
   outputs and attributes exact, ``delta_pos`` within eps * width); both
   segment-sum methods (``sorted_segment_sums``) on the voxelizer's own
   (2e6, 4) inputs against the CPU and against the voxelizer's outputs; the
   prefix method's ``ds_prefix_pack`` call against its plain version;
   ``voxelize`` and each method timed with CUDA events (median of 5). It
   runs first, so its host-bound times precede every profiler session
   (the pack's device time is taken after phase 7);
6. the CLIs: that cloud as a binary PLY in a temporary directory through
   ``cli.encode_ply.main`` (``--voxelize``, float32, bucket 2^19, the
   reference's 11-step grid, streams and CSV saved) and one stream through
   ``cli.decode.main``; the CSV, the PSNR order and the decoded colours
   checked, with the kernels' launch counts read around the run. Between
   the two, ``AttributeCodec.encode_sweep`` on the card over the same grid
   must give, step by step, the bytes of one ``encode`` per step and of the
   streams the CLI saved;
7. the 3DGS path: a seeded scene of 2 000 000 Gaussians on the phase 5
   shells (``utils/synth.py:gaussian_scene``, 56 attribute channels)
   voxelized and merged at J=10 on the card against the CPU (487 180
   voxels; integer outputs exact, merged attributes to ``GS_MERGE_TOL``);
   the CLI chain ``voxelize_3dgs --ply`` -> ``encode_3dgs`` (float32,
   bucket 2^19, the reference's 9 steps, streams and CSV saved) ->
   ``decode --color-space 3dgs`` of the finest stream, from PLYs in a
   temporary directory, and ``voxelize_3dgs --ckpt`` on a 100 000-Gaussian
   gsplat checkpoint, with the scan launches read around the chain; the
   CSV (PSNR and rate ordered by step, group PSNRs finite),
   ``encode_sweep`` against per-step ``encode`` and the saved streams,
   and the decoded PLY against an in-process decode; the scan kernel's
   wide path at its edges ((2049, 9); one tile with a ragged last column
   block, (2048, 17); full column blocks only, (70 000, 16); a tile count
   off the wave, (2^19 + 3, 57); 2048 and 2049 tiles at K = 12, the last
   one-block carry and the first recursive one; (2^22 + 5, 12)), each
   against its K = 1 scan, the transposed entry, the pack and a float64
   cumsum, the merge's (2e6, 60) segment sums by the prefix
   method against the shift method, and the packs of the transform
   ((2^19, 57) as the path gives it, (487 180, 57)) and of the merge, each
   against its plain version and a float64 cumsum, its last column
   bitwise its K=1 scan, the row, transposed and pack entries equal, run
   to run, then timed; the 3DGS golden fixture's float64 hash;
8. the dataset path: eight seeded 8iVFBv2 frames of about 0.8 M voxels
   at J=10 (``utils/synth.py:dataset_frame``, counts differing by frame)
   as binary PLYs in a tree kept for phase 12, through ``cli.encode_dataset`` with
   ``--batch 4`` (two batches, each padded to 2^20 rows) and as a frame
   loop (float32, bucket 2^19, the reference's 11 steps), the scan launches
   read around each run and held to 13 batched launches a batch (forward,
   inverse order, one per decoded step) and none of the single entry; the
   two CSVs' rates equal row by row, PSNR finite and ordered by step; in
   process, one batch's ``encode_sweep`` bytes against per-frame
   ``encode`` at every step and its batched decode against per-frame
   ``decode``, in float64 and float32; the kernel's batched entry at the path's (4, 2^20, 4) pack,
   on the wide path at (2, 2^19, 9) and (3, 2^19, 57), and past the
   one-block carry at (2, 2^22 + 5, 4) and
   (2, 2^22 + 5, 12), bitwise against the single entry frame by frame and
   against its plain version (integer lanes bitwise, float lanes 1e-12),
   then timed beside B single-entry calls;
9. the render comparison: the tiled rasterizer against the dense one on
   the card (2 000 Gaussians at 64x64, SH degree 0 and 3), against the
   port's CPU run of the same call (20 000 Gaussians of ``gaussian_scene``
   at 128x128, 2 views), and its early exit bitwise against a run of every
   chunk; then at full width, from PLYs in a temporary directory,
   ``voxelize_3dgs --ply`` with its default ``--render auto`` (5 views at
   512x512 of the phase 7 scene, 2e6 Gaussians, against its 487 180-voxel
   merge), ``encode_3dgs --render auto`` on the merged PLY (the finest
   step against the input) and ``encode_3dgs_debug --ablation`` (256x256),
   each asserting the backend (``jax``, the port's rasterizer, on ``cuda``
   tensors), finite PSNRs and pixels in [0, max(1, the scene's largest
   colour) + 1e-5]; then each view of both scenes timed with CUDA events
   after a warm-up, with its retries, overflow counts after them, blend
   chunks, host syncs and peak device memory, and the scan launches read
   around each CLI run;
10. the entropy and geometry coders: phase 6's raw cloud through
   ``encode_ply --code-geometry --entropy auto`` (one ext3 geometry section
   shared by every step's stream; every channel no larger than phase 6's
   RLGR stream nor than RAC alone; the same PSNRs), ``decode`` of the step-16
   stream without ``--positions`` against the decode with them (rows
   sorted by Morton code), a positions file with one voxel moved (exits),
   ``--geometry-lod 6`` against ``decode_geometry_lod``; phase 7's merged
   scene through ``encode_3dgs --code-geometry --entropy rac`` (the same
   PSNRs) and ``decode --color-space 3dgs`` without positions against the
   decode given the PLY; the golden fixture's RAC and auto float64 hashes
   against the CPU's; the geometry coder's bits a voxel and host times
   (ext3 and legacy) and RAC against RLGR per channel and per frame; the
   scan launches around each CLI run, the same as with RLGR;
11. predicted RAHT: the device encoder (``predict_impl`` auto on the card)
   against the host closed loop on phase 3's J10 frame at float32 and
   float64 (step 16; the float32 frame's scan launches read around its
   first encode and decode: one forward pack, no inverse), a J18 frame
   (int64 codes) and phase 7's 3DGS merge (56 channels, step 1): each
   stream decodes by the host loop within step / 2 per channel, the
   encoder's own reconstruction and the non-normative device decode
   within 1e-3 (float32) / 1e-9 (float64) of that decode over the
   channel's range; the share of symbols equal to the host encoder's and
   both masks; the J10 sweep (11 steps) against per-step encode, each
   step decoded; then ``encode_ply --predict`` on phase 6's raw cloud (11
   steps, streams equal to ``encode_sweep``'s, each flagged predicted,
   PSNR ordered by step, bytes against phase 6's plain RLGR), ``decode``
   of the step-16 stream in full and at half its coefficients, and
   ``encode_3dgs --predict`` on phase 7's merge (9 steps) with the decode
   of its finest stream, the scan launches read around each path (one
   pack, no transposed scan); times: the device encoder per step (CUDA
   events; kernel time and launches per step from the profiler), the host
   encoder and decoder (native; the numpy twin's decode at J10), the
   device decode, and peak device memory;
12. rate control: the rate model on the card against the same call on the
   CPU (relative error ``RATE_REL_TOL``) on phase 3's J10 frame at step 16
   and phase 7's 3DGS merge at step 1, with the 64-step grid's time (CUDA
   events), launches (profiler) and peak memory above the frame;
   ``search_step_for_bpp`` on phase 6's raw cloud at 1.1x its step-16
   rate, plain (in budget, its stream equal to ``encode`` at its step) and
   predicted (the device encoder; its stream decoded by the host loop
   within step / 2), and on a 20 000-voxel ``eval/synth.py`` frame with
   the same step, bytes and true encodes on the card and the CPU; then
   ``encode_ply --target-bpp --code-geometry`` on the raw cloud and
   ``decode`` without positions, ``encode_3dgs --target-bpp`` on the merge
   and its decode, and ``encode_dataset`` on 4 of phase 8's frames
   (its tree is kept) independent, ``--cbr``, ``--cbr --cbr-gop 2`` and
   ``--two-pass``: every frame within its budget, every prefix (a GOP's
   under ``--cbr-gop``) at or under the target, ``--cbr`` spending at
   least the independent mean, one step and the total in budget under
   ``--two-pass``; the scan launches read around each path;
13. sequences on phase 8's tree (8 frames, each shifted one voxel along
   x): the temporal ops (global and block motion, the strided search, the
   27-probe prediction) on the card against the CPU on frames 1 -> 2
   through both joins, each join timed (CUDA events, median of 5) with its
   peak memory; ``SequenceCodec(adaptive=False, gop=4)`` over the 8 frames
   in float32 (every encoder reconstruction bitwise ``decode_sequence``'s
   on the card; P-frame bytes against intra bytes at the same step, the
   signalled global motion, ``Predict_time``); ``encode_dataset --inter
   --gop 4 --code-geometry --save-sequence``, then ``decode --all-frames``
   without positions and ``decode --frame-index 5`` (a P-frame, replayed
   from frame 4: bitwise frame 5 of ``--all-frames``); ``--save-sequence``
   from the frame loop and from ``--batch 4`` (the same bytes); ``decode
   --frame-index 0 --lod 6`` against the CPU's ``decode_lod``;
   ``--target-bpp --inter`` on 4 frames (every frame within budget); the
   scan launches read around each path and held to PERF.md's counts.
   Every scan row also times ``torch.cumsum`` in float64 on the transposed
   (K, N) layout, with and without the transpose's copy;
14. tiled frames and serving: ``encode_3dgs --tiles 3 --code-geometry``
   on phase 7's merge (step 1, 24 bricks), ``decode --color-space 3dgs`` in
   full (bitwise the per-tile ``AttributeCodec.decode`` it is made of) and
   with ``--roi`` (bitwise the full decode clipped to the box), the merge
   tiled at brick depth 2 in process, bytes against the monolithic stream;
   ``encode_ply --voxelize --tiles 2`` on phase 6's raw cloud and
   ``encode_dataset --tiles 2 --save-sequence`` on 4 of phase 8's frames,
   ``decode --all-frames`` and ``decode --frame-index 2 --roi`` (equal to
   frame 2 clipped); serving at 4 views of 512x512 on the phase 9 orbit:
   ``serve_tiled_frame`` (culled, then an ROI's bricks), ``serve_frame``,
   ``serve_frame_predicted`` (on phase 11's stream; the device loop within
   1e-4 of the host decode) and ``serve_sequence`` (the merge shifted a
   voxel a frame, I P P P), each against the render of the normative decode,
   timed with CUDA events, with the rasterizer's counts and peak memory;
   ``cli.serve --u8`` on the three containers (PNGs read back by the
   phase's own decoder, the JSON line); the upload tiers on the served
   frame and a P-frame residual against an int32 upload. The scan launches
   are read around each path.

Needs one CUDA card; imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

REPLACES = {
    "ds_cumsum": "raht3dgs_tpu/ops/pallas_scan.py:57",          # _scan_kernel
    "ds_cumsum_t": "raht3dgs_tpu/ops/pallas_scan.py:94",        # _scan_kernel_t
    "ds_cumsum_batched": "raht3dgs_tpu/ops/pallas_scan.py:57",  # _scan_kernel under vmap
}
SOURCE = {
    "ds_cumsum": "raht3dgs_tpu_torch/csrc/ds_scan.cu",
    "ds_cumsum_t": "raht3dgs_tpu_torch/csrc/ds_scan.cu",
    "ds_cumsum_batched": "raht3dgs_tpu_torch/csrc/ds_scan.cu",
}
SINGLE = ("ds_cumsum", "ds_cumsum_t")   # the single-matrix entry's counts
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
DS_OPS_PER_ELEM = 11        # adds/subtracts of one ds_add per scanned element

N_RAW = 2_000_000          # phase 5/6 raw points
N_GS = 2_000_000           # phase 7 Gaussians (on the same shells as N_RAW)
GS_NVOX = 487_180          # their voxels at J=10
N_GS_CKPT = 100_000        # phase 7 checkpoint
GS_MERGE_TOL = 1e-5        # merged f32 attributes, card against CPU, relative
GS_SEG_TOL = 1e-5          # (N, 60) prefix segment sums against shift, per column
NVOX_RANGE = (400_000, 520_000)
N_VOX = 500_000
N_FRAMES = 8               # phase 8: dataset frames (8iVFBv2 loot 1000..1007)
BATCH = 4                  # phase 8: frames per batched call
NVOX_FRAME_RANGE = (750_000, 850_000)
N_RENDER_DENSE = 2_000     # phase 9: tiled against dense on the card, 64x64
N_RENDER_CPU = 20_000      # phase 9: the card against the CPU, 128x128, 2 views
RENDER_VIEWS = 5           # phase 9: the CLIs' render comparison, 512x512
RENDER_SIZE = 512
ABLATION_SIZE = 256
RENDER_DENSE_TOL = 2e-5    # tiled against dense, the same device
RENDER_CPU_TOL = 1e-4      # the card against the CPU (exp, log, sqrt and scans round apart)
PIXEL_TOL = 1e-5           # a pixel over its scene's largest colour (or the white background)
CARD = "cuda"              # the device phases 9 and 13 run on
DEPTH = 10
D_ATTR = 3
BUCKET = 1 << 19
STEP = 16.0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 20, warm: int = 3) -> float:
    """Median CUDA-event time of ``fn`` in ms."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, reps: int = 50, warm: int = 3):
    """The device's own time for one call of ``fn`` and the kernels it runs:
    torch.profiler's CUDA time of every kernel in ``reps`` back-to-back
    calls, divided by ``reps`` (host work of the wrapper excluded). Returns
    ms per call, kernel launches per call and us per call by kernel name.
    A session in which the profiler recorded no device activity at all is
    taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith("Mem")]
        if kernels:
            break
        print(f"device_ms: profiler session {attempt + 1} recorded no kernel",
              file=sys.stderr, flush=True)
    check(len(kernels) > 0, "the profiler saw no kernel on the card")
    split = {}
    for e in kernels:
        short = e.name.replace("(anonymous namespace)::", "")
        short = short.removeprefix("void ").split("(")[0]
        split[short] = split.get(short, 0.0) + e.time_range.elapsed_us() / reps
    ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    return ms, len(kernels) / reps, split


def run_counted(torch, ds, counts: dict, fn, *args):
    """``fn(*args)`` with its stdout held back and the scan launches it made
    added to ``counts``; ``(result, wall seconds, stdout)``."""
    import contextlib
    import io

    torch.cuda.synchronize()
    ds.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k, v in ds.LAUNCHES.items():
        counts[k] += v
    return res, wall, buf.getvalue()


def fair_library_ms(torch, xr, reps: int = 20) -> dict:
    """The fastest single library call for a scan row: ``torch.cumsum`` in
    float64 along the contiguous axis of the transposed layout ((K, N), or
    (B, K, N) for a stack), timed from the row's (N, K) input with the
    transpose and its copy counted (``library_t_ms``) and from a prepared
    float32 (K, N) copy (``library_t_nocopy_ms``)."""
    a, b = xr.dim() - 2, xr.dim() - 1
    xt = xr.transpose(a, b).contiguous()
    return {
        "library_t_ms": cuda_ms(torch, lambda: torch.cumsum(
            xr.transpose(a, b).contiguous().to(torch.float64), dim=b), reps=reps),
        "library_t_nocopy_ms": cuda_ms(torch, lambda: torch.cumsum(
            xt.to(torch.float64), dim=b), reps=reps),
    }


def ptxas_summary(log: str) -> dict:
    """{kernel<K,pair,batch>: [registers, spill bytes]} from nvcc -Xptxas=-v
    (the wide path's kernels as kernel<pair,batch>)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(ds_(?:tile|wide)_[a-z]+)I(?:Li(\d+)E)?"
                      r"Lb([01])ELb([01])E", ln)
        if m:
            k = f"{m.group(2)}," if m.group(2) else ""
            name = f"{m.group(1)}<{k}{m.group(3)},{m.group(4)}>"
            out[name] = [None, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            out[name][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name][0] = int(m.group(1))
    return out


def build_all():
    """Build every native library from the checkout's sources, in parallel."""
    from raht3dgs_tpu_torch.codec import geometry, rac, rlgr
    from raht3dgs_tpu_torch.ops import _praht_native
    from raht3dgs_tpu_torch.ops.ds_scan import KERNEL

    libs = {"nvcc ds_scan.cu": KERNEL, "g++ rlgr.cpp": rlgr.NATIVE,
            "g++ rac.cpp": rac.NATIVE, "g++ geom.cpp": geometry.NATIVE,
            "g++ praht.cpp": _praht_native.NATIVE}
    errors = []

    def run(lib):
        try:
            lib.build()
        except Exception as e:  # re-raised below, after every build ended
            errors.append(e)

    threads = [threading.Thread(target=run, args=(lib,)) for lib in libs.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for lib in libs.values():
        lib.load()
    return libs


def phase_kernels(torch, ds):
    """Each entry against the plain version on the card, on the same inputs.
    A kernel row times the call the main path makes at that shape: the
    forward's (2^19, 4) scan is ``ds_prefix_pack``, the kernel-written pack."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    n = BUCKET
    # the forward's fused pack: sqrt(w)-scaled colours + the weight lane
    attrs = torch.rand(n, D_ATTR, generator=g) * 255.0
    w = torch.zeros(n, 1)
    w[:N_VOX] = 1.0
    attrs[N_VOX:] = 0.0
    pack = torch.cat([attrs, w], dim=1).to(dev)
    cancel = torch.empty(4096, 1)
    cancel[0::2] = 1e7
    cancel[1::2] = -1e7 + 1.0
    cases = [
        # (kernel row, call, input, integer lanes, the main path's call)
        ("ds_cumsum", "ds_prefix_pack", pack, [D_ATTR], True),    # (2^19, 4)
        ("ds_cumsum", "ds_cumsum", pack, [D_ATTR], False),
        ("ds_cumsum", "ds_cumsum", w.to(dev), [0], False),                    # (2^19, 1)
        ("ds_cumsum_t", "ds_cumsum_t", pack.T.contiguous(), [D_ATTR], False),  # (4, 2^19)
        ("ds_cumsum_t", "ds_cumsum_t", w.T.contiguous().to(dev), [0], True),   # (1, 2^19)
        ("ds_cumsum", "ds_cumsum", cancel.to(dev), [], False),
    ]
    plain = {"ds_prefix_pack": ds.ds_prefix_pack_reference,
             "ds_cumsum": ds.ds_cumsum_reference,
             "ds_cumsum_t": lambda xt: ds.ds_cumsum_reference(xt.T)}

    def scan(call, x):
        """(hi, lo) of one call as (N, K) views; the pack's zero row checked."""
        if call == "ds_prefix_pack":
            P = ds.ds_prefix_pack(x)
            k = x.shape[1]
            check(P.shape == (x.shape[0] + 1, 2 * k) and not bool(P[0].any()),
                  "the pack's first row is not a zero row")
            return P[1:, :k], P[1:, k:]
        hi, lo = getattr(ds, call)(x)
        return (hi.T, lo.T) if call == "ds_cumsum_t" else (hi, lo)

    rows, timed = [], []
    for name, call, x, int_lanes, main in cases:
        xr = x.T if call == "ds_cumsum_t" else x             # (N, K) view
        hi, lo = scan(call, x)
        torch.cuda.synchronize()
        ph, pl = ds.ds_cumsum_reference(xr.contiguous())
        got = hi.double() + lo.double()
        ref = torch.cumsum(xr.double(), dim=0)
        scale = max(float(ref.abs().max()), 1.0)
        rel = float((got - ref).abs().max()) / scale
        max_abs = float((got - (ph.double() + pl.double())).abs().max())
        if xr.shape[0] == 4096:
            check(float((got - ref).abs().max()) < 1e-3, "cancellation case")
        else:
            check(rel < 1e-12, f"{call}{tuple(x.shape)} rel err {rel}")
        for k in int_lanes:
            check(torch.equal(hi[:, k], ph[:, k]) and not bool(lo[:, k].any()),
                  f"{call}{tuple(x.shape)} integer lane {k} not exact")
            check(torch.equal(hi[:, k].double(), ref[:, k]),
                  f"{call}{tuple(x.shape)} integer lane {k} != exact sum")
        say("kernels", call=call, shape=tuple(x.shape), rel_err=rel,
            max_abs_err_vs_plain=max_abs)
        if not main:
            continue
        N, K = xr.shape
        fn, plain_fn = getattr(ds, call), plain[call]
        # wrapper time first: a profiler session leaves the host busy for a
        # while after it ends, which would inflate the next host-bound time
        ms = cuda_ms(torch, lambda: fn(x), reps=100)
        plain_ms = cuda_ms(torch, lambda: plain_fn(x), reps=20, warm=1)
        lib_ms = cuda_ms(torch, lambda: torch.cumsum(xr, 0, dtype=torch.float64), reps=100)
        out_floats = (N + 1) * 2 * K if call == "ds_prefix_pack" else 2 * N * K
        bytes_ms = 4.0 * (N * K + out_floats) / HBM_BYTES_PER_S * 1e3
        ops_ms = DS_OPS_PER_ELEM * N * K / F32_OPS_PER_S * 1e3
        row = {
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": max_abs,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_ms,
            "call": call, "shape": list(x.shape), "kernel_ms": ms,
            "bound_us": max(bytes_ms, ops_ms) * 1e3,
        }
        row.update(fair_library_ms(torch, xr, reps=100))
        if call == "ds_prefix_pack":
            # the same input through ds_cumsum, (hi, lo) without the pack
            row["ds_cumsum_ms"] = cuda_ms(torch, lambda: ds.ds_cumsum(x), reps=100)
        rows.append(row)
        timed.append((row, fn, x))
    for row, fn, x in timed:
        row["device_ms"], row["device_launches_per_call"], split = device_ms(
            torch, lambda: fn(x))
        row["device_us_by_kernel"] = split
        if row["call"] == "ds_prefix_pack":
            row["ds_cumsum_device_ms"], _, _ = device_ms(torch, lambda: ds.ds_cumsum(x))
        say("kernels", call=row["call"], shape=tuple(x.shape), wrapper_ms=row["ms"],
            device_ms=row["device_ms"],
            device_launches_per_call=row["device_launches_per_call"],
            by_kernel_us=json.dumps(split), ds_cumsum_wrapper_ms=row.get("ds_cumsum_ms"),
            ds_cumsum_device_ms=row.get("ds_cumsum_device_ms"))
    return rows


def phase_invariants(torch, ds):
    """The scan's bitwise properties that the codec relies on, on the card,
    with fractional data, and its edge sizes against a float64 cumsum."""
    from raht3dgs_tpu_torch.ops.raht_span import _prefix_pack

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    # the kernel counts its own scratch: it takes exactly scratch_floats and
    # refuses one float less without launching
    lib = ds.KERNEL.load()
    for n in (1, 2048, 2049, 2048 * 256, 2048 * 2048 + 1, (1 << 23) + 3):
        for k in (1, 4):
            need = ds.scratch_floats(n, k)
            x = torch.zeros(n, k, device=dev)
            out = torch.empty(2 * n * k, device=dev)
            scratch = torch.empty(max(need, 1), device=dev)
            check(lib.ds_cumsum_f32(x.data_ptr(), n, k, k, 1, 0, out.data_ptr(),
                                    scratch.data_ptr(), need - 1, None) == -3,
                  f"the kernel took {need - 1} floats of scratch for ({n}, {k})")
            check(lib.ds_cumsum_f32(x.data_ptr(), n, k, k, 1, 0, out.data_ptr(),
                                    scratch.data_ptr(), need, None) == 0,
                  f"the kernel refused scratch_floats({n}, {k})")
    torch.cuda.synchronize()

    def same(a, b):
        return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def zero_pack(hi, lo):
        return torch.cat([torch.zeros(1, 2 * hi.shape[1], device=dev),
                          torch.cat([hi, lo], dim=1)])

    x = (torch.rand(BUCKET, 4, generator=g) * 3.0).to(dev)
    hi, lo = ds.ds_cumsum(x)
    check(same((hi, lo), ds.ds_cumsum(x)), "two calls on one input differ")
    for k in range(4):
        h1, l1 = ds.ds_cumsum(x[:, k:k + 1].contiguous())
        check(same((hi[:, k:k + 1], lo[:, k:k + 1]), (h1, l1)),
              f"lane {k} of the pack differs from its K=1 scan")
        check(same((h1, l1), tuple(t.reshape(-1, 1) for t in
                                   ds.ds_cumsum_t(x[:, k].reshape(1, -1).contiguous()))),
              f"lane {k}: K=1 row entry differs from the transposed entry")
    ht, lt = ds.ds_cumsum_t(x.T.contiguous())
    check(same((ht.T, lt.T), (hi, lo)), "row entry differs from transposed entry")
    check(torch.equal(_prefix_pack(x, True), zero_pack(hi, lo)),
          "kernel-written pack differs from cat of hi, lo under a zero row")
    h3, l3 = ds.ds_cumsum(x[:, 3:].contiguous())
    check(torch.equal(_prefix_pack(x[:, 3:].contiguous(), True), zero_pack(h3, l3)),
          "kernel-written K=1 pack differs")
    say("invariants", shape=(BUCKET, 4), k_independent=True, layout_independent=True,
        deterministic=True, pack_equals_cat=True)

    for n, k in ((1, 4), (2047, 4), (2049, 4), ((1 << 23) + 3, 1)):
        frac = torch.rand(n, k, generator=g) * 100.0
        ints = (torch.rand(n, 1, generator=g) < 0.5).float()
        for name, xc in (("frac", frac.to(dev)), ("int", ints.to(dev))):
            h, l = ds.ds_cumsum(xc)
            got = h.double() + l.double()
            ref = torch.cumsum(xc.double(), dim=0)
            rel = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1.0)
            check(rel < 1e-12, f"edge ({n}, {xc.shape[1]}) {name}: rel err {rel}")
            if name == "int":
                check(torch.equal(h.double(), ref) and not bool(l.any()),
                      f"edge ({n}, 1) integer lane not exact")
            kk = xc.shape[1]
            ht, lt = ds.ds_cumsum_t(xc.T.contiguous())
            check(same((ht.T, lt.T), (h, l)), f"edge ({n}, {kk}) {name}: layouts differ")
            check(torch.equal(_prefix_pack(xc, True), zero_pack(h, l)),
                  f"edge ({n}, {kk}) {name}: pack differs")
            if kk > 1:
                h1, l1 = ds.ds_cumsum(xc[:, -1:].contiguous())
                check(same((h[:, -1:], l[:, -1:]), (h1, l1)),
                      f"edge ({n}, {kk}) {name}: last lane != its K=1 scan")
            say("edges", n=n, k=kk, data=name, rel_err=rel)


def run_frame(FrameStream, frame, codec):
    enc = codec.encode(frame, STEP)
    stream = FrameStream.from_bytes(enc.stream.to_bytes())
    rec, dtimer = codec.decode(stream, frame.codes, frame.weights)
    return enc, rec, dtimer


def phase_main(torch, ds):
    import numpy as np

    from raht3dgs_tpu_torch.codec.bitstream import FrameStream
    from raht3dgs_tpu_torch.models import pipeline as tp
    from raht3dgs_tpu_torch.ops.raht_span import raht_forward_span, raht_inverse_span
    from raht3dgs_tpu_torch.utils.synth import synthetic_positions

    results = {}
    for depth, seed in ((DEPTH, 0), (18, 1)):
        t0 = time.perf_counter()
        pts, attrs = synthetic_positions(N_VOX, depth, D_ATTR, seed=seed)
        frame = tp.prepare_voxel_frame(pts, attrs, depth, bucket=BUCKET,
                                       dtype=torch.float32)
        prep_s = time.perf_counter() - t0
        codec = tp.AttributeCodec(depth, dtype=torch.float32)
        n = frame.n_voxels
        check(n == N_VOX, f"frame has {n} voxels")
        run_frame(FrameStream, frame, codec)  # warm-up
        torch.cuda.synchronize()

        torch.cuda.reset_peak_memory_stats()
        ds.reset_launches()
        enc, rec, dtimer = run_frame(FrameStream, frame, codec)
        torch.cuda.synchronize()
        launches = dict(ds.LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        total = sum(launches.values())
        check(total >= 3, f"scan kernel launched {total} times in one encode+decode")
        for name in SINGLE:
            check(launches[name] >= 1, f"{name} not launched on the main path")
        # one forward pack, two one-column weight scans in the decode
        check(launches == {"ds_cumsum": 1, "ds_cumsum_t": 2, "ds_cumsum_batched": 0},
              f"scan launches in one encode+decode {launches}")

        want = frame.attributes[:n].cpu().numpy()
        check(rec.shape == (n, D_ATTR) and np.isfinite(rec).all(), "decode output")
        rmse = float(np.sqrt(np.mean((rec - want) ** 2)))
        check(rmse <= STEP / 2, f"rmse {rmse} above the quantization bound")

        fwd = raht_forward_span(frame.codes, frame.attributes, frame.weights, depth)
        inv = raht_inverse_span(fwd.coeffs, frame.codes, frame.weights, depth)
        rt_err = float((inv[:n] - frame.attributes[:n]).abs().max())
        check(rt_err < 1e-2, f"transform round trip error {rt_err}")

        def roundtrip():
            f = raht_forward_span(frame.codes, frame.attributes, frame.weights, depth)
            raht_inverse_span(f.coeffs, frame.codes, frame.weights, depth)

        rt_ms = cuda_ms(torch, roundtrip, reps=5, warm=1)
        e2e = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run_frame(FrameStream, frame, codec)
            torch.cuda.synchronize()
            e2e.append(time.perf_counter() - t1)
        e2e_s = statistics.median(e2e)
        stages = {**enc.timer.stages, **dtimer.stages}
        results[depth] = {
            "launches": launches, "rmse": rmse, "roundtrip_err": rt_err,
            "roundtrip_mpts": n / (rt_ms / 1e3) / 1e6,
            "e2e_mpts": n / e2e_s / 1e6, "e2e_s": e2e_s,
            "bytes": len(enc.stream.to_bytes()), "prepare_s": prep_s,
            "peak_mem_gib": peak_gib,
            "stages_s": {k: round(v, 6) for k, v in stages.items()},
        }
        say("main", depth=depth, n=n, **{k: json.dumps(v) if isinstance(v, dict)
                                         else v for k, v in results[depth].items()})
    return results


def phase_golden(torch):
    from raht3dgs_tpu_torch.models import pipeline as tp
    from raht3dgs_tpu_torch.utils import synth

    pts, attrs = synth.golden_fixture()
    out = {}
    for name, dt in (("float64", torch.float64), ("float32", torch.float32)):
        frame = tp.prepare_voxel_frame(pts, attrs, synth.GOLDEN_DEPTH,
                                       bucket=synth.GOLDEN_BUCKET, dtype=dt)
        blob = tp.AttributeCodec(synth.GOLDEN_DEPTH, dtype=dt).encode(
            frame, steps=synth.GOLDEN_STEP).stream.to_bytes()
        out[name] = hashlib.sha256(blob).hexdigest()
    f64_ok = out["float64"] == synth.GOLDEN_SHA256["float64"]
    # the float32 stream rides the scan kernel, whose association differs
    # from the CPU's plain scan: reported, not required
    say("golden", f64_sha256=out["float64"], f64_matches_cpu=f64_ok,
        f32_sha256=out["float32"],
        f32_matches_cpu=out["float32"] == synth.GOLDEN_SHA256["float32"])
    check(f64_ok, "float64 golden stream on the card differs from the CPU hash")


def segment_inputs(torch, PC, res):
    """The (values, first, extra) that ``voxelize`` hands its segment sums,
    rebuilt from its result (every input row valid): (N, D+1) sorted
    attributes and the valid lane, run starts, code lanes and coordinates."""
    from raht3dgs_tpu_torch.ops.raht import _code_lanes

    pv = res.point_voxel.long()
    ones = torch.ones(len(pv), 1, dtype=PC.dtype, device=PC.device)
    vals = torch.cat([PC[res.sort_idx.long(), 3:], ones], dim=1)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=pv.device), pv[1:] != pv[:-1]])
    extra = torch.cat([_code_lanes(res.codes[pv], PC.dtype), res.positions[pv].to(PC.dtype)],
                      dim=1)
    return vals, first, extra


def phase_voxelize(torch, ds):
    """Phase 5: the raw J10 cloud voxelized on the card against the CPU;
    both segment-sum methods on the voxelizer's own inputs against the CPU
    and the voxelizer; the prefix method's scan against its plain version."""
    import numpy as np

    from raht3dgs_tpu_torch.ops.segment import METHODS, sorted_segment_sums
    from raht3dgs_tpu_torch.ops.voxelize import voxelize
    from raht3dgs_tpu_torch.utils.synth import raw_surface_cloud

    pts, rgb = raw_surface_cloud(N_RAW, seed=0)
    PC = torch.from_numpy(np.concatenate([pts, rgb.astype(np.float32)], axis=1))
    PCg = PC.cuda()
    eps32 = float(np.finfo(np.float32).eps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ds.reset_launches()
    g = voxelize(PCg, DEPTH)
    torch.cuda.synchronize()
    launches = dict(ds.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    c = voxelize(PC, DEPTH, device="cpu")
    for f in ("codes", "positions", "counts", "nvox", "sort_idx", "point_voxel"):
        check(torch.equal(getattr(g, f).cpu(), getattr(c, f)),
              f"voxelize: {f} differs between the card and the CPU")
    nvox = int(g.nvox)
    check(NVOX_RANGE[0] <= nvox <= NVOX_RANGE[1], f"raw cloud gave {nvox} voxels")
    # the shift method: the same adds in the same order on both devices
    attr_err = float((g.attributes.cpu() - c.attributes).abs().max())
    dattr_err = float((g.delta_attr.cpu() - c.delta_attr).abs().max())
    dpos_err = float((g.delta_pos.cpu() - c.delta_pos).abs().max())
    check(attr_err == 0.0 and dattr_err == 0.0,
          f"voxelize: attributes off by {attr_err}, delta_attr by {dattr_err}")
    check(dpos_err <= eps32 * float(c.width), f"voxelize: delta_pos {dpos_err}")
    check(sum(launches.values()) == 0, f"voxelize: scan launches {launches}")
    max_run = int(c.counts.max())
    ms = cuda_ms(torch, lambda: voxelize(PCg, DEPTH), reps=5, warm=1)
    out = {"voxelize": {"ms": ms, "peak_mem_gib": peak_gib, "attr_err": attr_err,
                        "delta_pos_err": dpos_err}}
    say("voxelize", n_points=N_RAW, nvox=nvox, max_run=max_run,
        shift_passes=(max_run - 1).bit_length(), **out["voxelize"])

    on_card, on_cpu = segment_inputs(torch, PCg, g), segment_inputs(torch, PC, c)
    D = on_card[0].shape[1] - 1
    for method in METHODS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ds.reset_launches()
        sums, extra, _, n_seg = sorted_segment_sums(*on_card, method=method)
        torch.cuda.synchronize()
        launches = dict(ds.LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        sc, ec, _, _ = sorted_segment_sums(*on_cpu, method=method)
        check(int(n_seg) == nvox, f"{method}: {int(n_seg)} runs")
        check(torch.equal(sums[:, D].cpu(), c.counts) and torch.equal(extra.cpu(), ec),
              f"{method}: counts or codes/coordinates differ from the CPU's")
        # prefix: the kernel's association differs from the plain scan's
        sum_err = float((sums.cpu() - sc).abs().max())
        tol = 0.0 if method == "shift" else 1e-6 * float(sc.abs().max())
        check(sum_err <= tol, f"{method}: sums off the CPU's by {sum_err} (tol {tol})")
        means = sums[:, :D] / torch.clamp_min(sums[:, D], 1.0)[:, None]
        mean_err = float((means - g.attributes).abs().max())
        check(mean_err <= (0.0 if method == "shift" else 1e-6 * float(c.attributes.abs().max())),
              f"{method}: means off the voxelizer's by {mean_err}")
        check(launches == {"ds_cumsum": int(method == "prefix"), "ds_cumsum_t": 0,
                           "ds_cumsum_batched": 0},
              f"{method}: scan launches {launches}")
        ms = cuda_ms(torch, lambda: sorted_segment_sums(*on_card, method=method), reps=5, warm=1)
        out[method] = {"ms": ms, "launches": launches,
                       "peak_mem_gib": peak_gib, "sum_err": sum_err, "mean_err": mean_err}
        say("segment_sums", method=method, shape=tuple(on_card[0].shape),
            **{k: json.dumps(v) if isinstance(v, dict) else v for k, v in out[method].items()})

    # the prefix method's scan: (N, D+1) sorted colours and the valid lane
    vals = on_card[0]
    P = ds.ds_prefix_pack(vals)
    R = ds.ds_prefix_pack_reference(vals)
    torch.cuda.synchronize()
    K = vals.shape[1]
    got = P[:, :K].double() + P[:, K:].double()
    ref = torch.cumsum(torch.cat([vals.new_zeros(1, K), vals]).double(), 0)
    max_abs = float((got - (R[:, :K].double() + R[:, K:].double())).abs().max())
    rel = float((got - ref).abs().max()) / float(ref.abs().max())
    check(rel < 1e-12, f"voxelize pack rel err {rel}")
    check(torch.equal(P[:, K - 1], R[:, K - 1]) and not bool(P[:, 2 * K - 1].any())
          and torch.equal(P[:, K - 1].double(), ref[:, K - 1]),
          "voxelize pack: the integer lane is not exact")
    pack_ms = cuda_ms(torch, lambda: ds.ds_prefix_pack(vals), reps=20)
    plain_ms = cuda_ms(torch, lambda: ds.ds_prefix_pack_reference(vals), reps=5, warm=1)
    lib_ms = cuda_ms(torch, lambda: torch.cumsum(vals, 0, dtype=torch.float64), reps=20)
    bytes_ms = 4.0 * (N_RAW * K + (N_RAW + 1) * 2 * K) / HBM_BYTES_PER_S * 1e3
    ops_ms = DS_OPS_PER_ELEM * N_RAW * K / F32_OPS_PER_S * 1e3
    out["pack"] = {"call": "ds_prefix_pack", "shape": [N_RAW, K], "ms": pack_ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms, "max_abs_err": max_abs,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                   **fair_library_ms(torch, vals)}
    say("voxelize", rel_err=rel, **out["pack"])
    return out, vals


def phase_cli(torch, ds, keep):
    """Phase 6: encode_ply --voxelize over the 11-step grid and decode, in
    process, from a binary PLY in a temporary directory (the raw PLY and the
    voxel positions' PLY move to ``keep`` for phase 10)."""
    import csv
    import math
    import os
    import tempfile

    import numpy as np

    from raht3dgs_tpu_torch.cli import decode, encode_ply
    from raht3dgs_tpu_torch.cli._common import quant_kwargs
    from raht3dgs_tpu_torch.codec.bitstream import FrameStream
    from raht3dgs_tpu_torch.config import ColorCodecConfig
    from raht3dgs_tpu_torch.io.ply import read_ply_8i, save_ply_ascii
    from raht3dgs_tpu_torch.models import pipeline as tp
    from raht3dgs_tpu_torch.models.color_codec import CSV_HEADER
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv, yuv_to_rgb
    from raht3dgs_tpu_torch.ops.voxelize import voxelize
    from raht3dgs_tpu_torch.utils.synth import (
        morton_codes_np,
        raw_surface_cloud,
        write_binary_ply,
    )

    steps = list(ColorCodecConfig.steps)
    pts, rgb = raw_surface_cloud(N_RAW, seed=0)
    launches = {name: 0 for name in ds.LAUNCHES}
    with tempfile.TemporaryDirectory() as tmp:
        ply, csv_path = os.path.join(tmp, "raw.ply"), os.path.join(tmp, "rd.csv")
        sdir = os.path.join(tmp, "streams")
        write_binary_ply(ply, pts, rgb.astype(np.uint8))
        argv = ["--input", ply, "--voxelize", "--depth", str(DEPTH), "--dtype", "float32",
                "--bucket", str(BUCKET), "--save-streams", sdir, "--csv", csv_path,
                "--steps", *[f"{s:g}" for s in steps]]
        torch.cuda.synchronize()
        ds.reset_launches()
        t0 = time.perf_counter()
        check(encode_ply.main(argv) == 0, "encode_ply failed")
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        for k, v in ds.LAUNCHES.items():
            launches[k] += v

        with open(csv_path) as f:
            lines = f.read().splitlines()
        check(len(lines) == 1 + len(steps) and lines[0] == CSV_HEADER,
              f"CSV has {len(lines)} lines, header {lines[0]!r}")
        rows = list(csv.DictReader(lines))
        check(all(len(r) == 11 for r in rows), "CSV rows are not 11 columns")
        psnr = [float(r["psnr"]) for r in rows]
        check(all(math.isfinite(p) for p in psnr), f"PSNR {psnr}")
        check(all(a >= b for a, b in zip(psnr, psnr[1:])), f"PSNR falls as step falls: {psnr}")
        stage_s = {k: sum(float(r[k]) for r in rows) for k in lines[0].split(",")[3:10]}

        # the CLI's frame, rebuilt as encode_color_frame builds it
        V, C, _ = read_ply_8i(ply)
        res = voxelize(torch.as_tensor(np.concatenate([V, C], 1), device="cuda").float(),
                       DEPTH)
        nvox = int(res.nvox)
        pos = res.positions[:nvox].cpu().numpy()
        yuv = rgb_to_yuv(res.attributes[:nvox], dtype=torch.float32)
        vframe = tp.prepare_voxel_frame(pos.astype(np.int64), yuv.cpu().numpy(), DEPTH,
                                        bucket=BUCKET, dtype=torch.float32)
        # the sweep on the card (pinned buffers, fetch thread, buffer reuse)
        # against one encode per step on the same coefficients, and against
        # the streams the CLI saved, byte for byte
        codec = tp.AttributeCodec(DEPTH, dtype=torch.float32,
                                  **quant_kwargs(encode_ply.build_parser().parse_args(argv)))
        coeffs, order, _, _ = codec.transform(vframe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep = codec.encode_sweep(vframe, steps)
        sweep_s = time.perf_counter() - t0
        check(len(sweep) == len(steps), f"encode_sweep gave {len(sweep)} streams")
        t0 = time.perf_counter()
        per_step = [codec.encode(vframe, s, coeffs=coeffs, order=order) for s in steps]
        per_step_s = time.perf_counter() - t0
        channel_bytes = []
        for s, enc, one in zip(steps, sweep, per_step):
            blob = enc.stream.to_bytes()
            channel_bytes.append([len(c) for c in enc.stream.channels])
            check(blob == one.stream.to_bytes(), f"encode_sweep step {s:g} != encode")
            with open(os.path.join(sdir, f"frame0001_step{s:g}.r3tc"), "rb") as f:
                check(blob == f.read(), f"the CLI's stream at step {s:g} != encode_sweep")
        say("cli", sweep_bytes_equal_encode=len(steps), encode_sweep_s=sweep_s,
            per_step_encode_s=per_step_s)

        # the voxelized positions as an 8i PLY, then one stream through decode
        pos_ply, out_ply = os.path.join(tmp, "pos.ply"), os.path.join(tmp, "rec.ply")
        write_binary_ply(pos_ply, pos)
        stream_path = os.path.join(sdir, "frame0001_step16.r3tc")
        torch.cuda.synchronize()
        ds.reset_launches()
        t0 = time.perf_counter()
        check(decode.main(["--stream", stream_path, "--positions", pos_ply, "--output",
                           out_ply, "--dtype", "float32", "--bucket", str(BUCKET)]) == 0,
              "decode failed")
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        for k, v in ds.LAUNCHES.items():
            launches[k] += v

        with open(stream_path, "rb") as f:
            stream = FrameStream.from_bytes(f.read())
        frame = tp.prepare_voxel_frame(pos, np.zeros((nvox, 3)), DEPTH, bucket=BUCKET,
                                       dtype=torch.float32)
        rec, _ = tp.AttributeCodec(DEPTH, dtype=torch.float32).decode(
            stream, frame.codes, frame.weights)
        out_attrs = np.empty_like(rec)
        out_attrs[np.argsort(morton_codes_np(pos, DEPTH), kind="stable")] = rec
        want = np.clip(yuv_to_rgb(torch.as_tensor(out_attrs, device="cuda")).cpu().numpy(),
                       0, 255).astype(int)
        V2, C2, _ = read_ply_8i(out_ply)
        check(np.array_equal(V2, pos.astype(float)) and np.array_equal(C2, want),
              "decoded PLY differs from the in-process decode")
        # the decode CLI's last step alone: the ASCII PLY writer on this host
        t0 = time.perf_counter()
        save_ply_ascii(os.path.join(tmp, "again.ply"), V2, want)
        write_s = time.perf_counter() - t0
        for name in ("raw.ply", "pos.ply"):
            os.replace(os.path.join(tmp, name), os.path.join(keep, name))
    for name in SINGLE:
        check(launches[name] >= 1, f"{name} not launched on the CLI path")
    # one forward pack; two weight scans per decode (11 in the sweep, 1 in the CLI)
    check(launches == {"ds_cumsum": 1, "ds_cumsum_t": 2 * (len(steps) + 1),
                       "ds_cumsum_batched": 0},
          f"scan launches on the CLI path {launches}")
    out = {"nvox": nvox, "steps": len(steps), "encode_ply_s": enc_s,
           "sweep_mpts": nvox * len(steps) / enc_s / 1e6, "decode_cli_s": dec_s,
           "ply_write_s": write_s,
           "launches": launches, "stage_s": stage_s, "psnr": psnr,
           "bpp": [float(r["Rate_bpp"]) for r in rows]}
    say("cli", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                  for k, v in out.items()})
    out["channel_bytes"] = channel_bytes   # RLGR, per step and channel (phase 10)
    return out


def write_gsplat_ckpt(torch, path, scene) -> None:
    """``scene`` as a gsplat checkpoint: float32 tensors in training space
    (log scales, logit opacities, SH as sh0 (N, 1, 3) and shN (N, 15, 3))."""
    import numpy as np

    n = len(scene["means"])
    sh = scene["colors"].reshape(n, 16, 3)
    op = scene["opacities"]
    splats = {"means": scene["means"], "quats": scene["quats"],
              "scales": np.log(scene["scales"]), "opacities": np.log(op / (1.0 - op)),
              "sh0": sh[:, :1], "shN": sh[:, 1:]}
    torch.save({"splats": {k: torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float32)
                           for k, v in splats.items()}}, path)


def check_pack(torch, ds, body):
    """The kernel-written pack of ``body`` (N, K) against its plain version
    and a float64 cumsum, its last column against that column's K=1 scan,
    its (hi, lo) against ``ds_cumsum`` and the transposed entry, and a
    second run. Returns (rel. error against f64, max abs error against
    the plain version)."""
    N, K = body.shape
    P = ds.ds_prefix_pack(body)
    R = ds.ds_prefix_pack_reference(body)
    torch.cuda.synchronize()
    got = P[1:, :K].double() + P[1:, K:].double()
    ref = torch.cumsum(body.double(), 0)
    rel = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1.0)
    max_abs = float((got - (R[1:, :K].double() + R[1:, K:].double())).abs().max())
    check(P.shape == (N + 1, 2 * K) and not bool(P[0].any()), f"({N}, {K}) pack: zero row")
    check(rel < 1e-12, f"({N}, {K}) pack: rel err {rel} against an f64 cumsum")
    h1, l1 = ds.ds_cumsum(body[:, K - 1:].contiguous())
    check(torch.equal(P[1:, K - 1], h1[:, 0]) and torch.equal(P[1:, 2 * K - 1], l1[:, 0]),
          f"({N}, {K}) pack: the last column differs from its K=1 scan")
    hi, lo = ds.ds_cumsum(body)
    ht, lt = ds.ds_cumsum_t(body.T.contiguous())
    check(torch.equal(P[1:, :K], hi) and torch.equal(P[1:, K:], lo)
          and torch.equal(ht.T, hi) and torch.equal(lt.T, lo),
          f"({N}, {K}): the pack, ds_cumsum and ds_cumsum_t differ")
    check(torch.equal(P, ds.ds_prefix_pack(body)), f"({N}, {K}) pack: two runs differ")
    return rel, max_abs


def wide_pack_row(torch, ds, body, reps=100):
    """:func:`check_pack`, then the times of the wrapper, the plain version
    and ``torch.cumsum`` f64 on ``body``."""
    N, K = body.shape
    rel, max_abs = check_pack(torch, ds, body)
    ms = cuda_ms(torch, lambda: ds.ds_prefix_pack(body), reps=reps)
    plain_ms = cuda_ms(torch, lambda: ds.ds_prefix_pack_reference(body), reps=3, warm=1)
    lib_ms = cuda_ms(torch, lambda: torch.cumsum(body, 0, dtype=torch.float64), reps=reps)
    bytes_ms = 4.0 * (N * K + (N + 1) * 2 * K) / HBM_BYTES_PER_S * 1e3
    ops_ms = DS_OPS_PER_ELEM * N * K / F32_OPS_PER_S * 1e3
    return {"call": "ds_prefix_pack", "shape": [N, K], "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "max_abs_err": max_abs, "rel_err": rel,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            **fair_library_ms(torch, body, reps=min(reps, 20))}


def add_device_ms(torch, ds, row, x) -> None:
    """The device's own time of ``ds_prefix_pack(x)`` into ``row``; run
    after every host-bound timing (a profiler session leaves the host busy)."""
    row["device_ms"], row["device_launches_per_call"], row["device_us_by_kernel"] = \
        device_ms(torch, lambda: ds.ds_prefix_pack(x))


def phase_gs(torch, ds, keep):
    """Phase 7: the 3DGS path at full width (the merged PLY moves to
    ``keep`` for phase 10). A 2e6-Gaussian scene voxelized
    and merged on the card against the CPU; the CLI chain voxelize_3dgs ->
    encode_3dgs (9 steps, 56 channels) -> decode --color-space 3dgs from a
    PLY in a temporary directory, with the scan launches read around it;
    encode_sweep against per-step encode and the saved streams; a small
    checkpoint through voxelize_3dgs --ckpt; the scan kernel's wide path
    at the transform's pack and the merge's (N, 60) segment sums; the 3DGS
    golden hashes."""
    import csv
    import hashlib
    import math
    import os
    import tempfile

    import numpy as np

    from raht3dgs_tpu_torch.cli import decode, encode_3dgs, voxelize_3dgs
    from raht3dgs_tpu_torch.codec.bitstream import FrameStream
    from raht3dgs_tpu_torch.config import GsCodecConfig
    from raht3dgs_tpu_torch.io.ply import read_compressed_3dgs_ply, save_ply_3dgs
    from raht3dgs_tpu_torch.models import pipeline as tp
    from raht3dgs_tpu_torch.models.gs_codec import CSV_HEADER
    from raht3dgs_tpu_torch.models.gs_voxelize import GS_KEYS, compress_to_nvox, merge_rows
    from raht3dgs_tpu_torch.ops.segment import sorted_segment_sums
    from raht3dgs_tpu_torch.utils import synth

    out = {}
    steps = list(GsCodecConfig.steps)
    scene = synth.gaussian_scene(N_GS, seed=0)

    # voxelize + merge on the card against the CPU
    g = compress_to_nvox(scene, depth=DEPTH)
    c = compress_to_nvox(scene, depth=DEPTH, device="cpu")
    nvox = g.n_voxels
    check(nvox == c.n_voxels == GS_NVOX, f"compress_to_nvox: {nvox} / {c.n_voxels} voxels")
    for f in ("positions_int", "cluster_of_input"):
        check(np.array_equal(getattr(g, f), getattr(c, f)), f"compress_to_nvox: {f} differs")
    attr_err = {}
    for f in ("quats", "scales", "opacities", "colors", "means_world"):
        a, b = getattr(g, f)[:nvox], getattr(c, f)[:nvox]
        attr_err[f] = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)
        check(attr_err[f] <= GS_MERGE_TOL, f"compress_to_nvox: {f} off by {attr_err[f]}")
    say("gs", n_gaussians=N_GS, nvox=nvox, merge_rel_err=json.dumps(attr_err),
        merge_tol=GS_MERGE_TOL)

    launches = {name: 0 for name in ds.LAUNCHES}

    def run(cli, argv):
        torch.cuda.synchronize()
        ds.reset_launches()
        t0 = time.perf_counter()
        check(cli.main(argv) == 0, f"{cli.__name__} failed")
        torch.cuda.synchronize()
        for k, v in ds.LAUNCHES.items():
            launches[k] += v
        return time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        scene_ply = os.path.join(tmp, "scene.ply")
        save_ply_3dgs(scene_ply, *(scene[k] for k in GS_KEYS))
        odir, sdir = os.path.join(tmp, "vox"), os.path.join(tmp, "streams")
        vcsv, ecsv = os.path.join(tmp, "vox.csv"), os.path.join(tmp, "gs.csv")
        comp = os.path.join(odir, "compressed_Nvox_gaussians.ply")
        torch.cuda.reset_peak_memory_stats()
        vox_s = run(voxelize_3dgs, ["--ply", scene_ply, "--depth", str(DEPTH), "--render",
                                    "none", "--output-dir", odir, "--csv", vcsv])
        with open(vcsv) as f:
            vrow = list(csv.DictReader(f))[0]
        check(int(vrow["N_vox"]) == GS_NVOX, f"voxelize_3dgs: {vrow['N_vox']} voxels")
        enc_s = run(encode_3dgs, ["--input", comp, "--depth", str(DEPTH), "--dtype", "float32",
                                  "--bucket", str(BUCKET), "--render", "none",
                                  "--save-streams", sdir, "--csv", ecsv,
                                  "--steps", *[f"{s:g}" for s in steps]])
        with open(ecsv) as f:
            lines = f.read().splitlines()
        check(len(lines) == 1 + len(steps) and lines[0] == CSV_HEADER,
              f"encode_3dgs CSV has {len(lines)} lines")
        rows = list(csv.DictReader(lines))
        psnr = [float(r["PSNR_all"]) for r in rows]
        bpp = [float(r["Rate_bpp"]) for r in rows]
        groups = [float(r[k]) for r in rows for k in
                  ("PSNR_quats", "PSNR_scales", "PSNR_opacity", "PSNR_colors")]
        check(all(math.isfinite(p) for p in psnr + groups), f"PSNR {psnr}")
        check(all(a > b for a, b in zip(psnr, psnr[1:])), f"PSNR not ordered by step: {psnr}")
        check(all(a > b for a, b in zip(bpp, bpp[1:])), f"rate not ordered by step: {bpp}")
        stage_s = {k: sum(float(r[k]) for r in rows) for k in lines[0].split(",")[3:12]}

        # the sweep on the card against one encode per step and the saved
        # streams, byte for byte
        V, A, vsize, vmin = read_compressed_3dgs_ply(comp)
        frame = tp.prepare_voxel_frame(V, A.astype(np.float64), DEPTH, bucket=BUCKET,
                                       dtype=torch.float32, vmin=vmin,
                                       width=vsize * (1 << DEPTH))
        codec = tp.AttributeCodec(DEPTH, dtype=torch.float32)
        coeffs, order, _, _ = codec.transform(frame)
        sweep = codec.encode_sweep(frame, steps, coeffs=coeffs, order=order)
        for s, enc in zip(steps, sweep):
            blob = enc.stream.to_bytes()
            check(blob == codec.encode(frame, s, coeffs=coeffs, order=order).stream.to_bytes(),
                  f"encode_sweep step {s:g} != encode")
            with open(os.path.join(sdir, f"gs_step{s:g}.r3tc"), "rb") as f:
                check(blob == f.read(), f"the CLI's stream at step {s:g} != encode_sweep")

        # the finest stream through the decode CLI, against an in-process decode
        stream_path = os.path.join(sdir, f"gs_step{min(steps):g}.r3tc")
        rec_ply = os.path.join(tmp, "rec.ply")
        dec_s = run(decode, ["--stream", stream_path, "--positions", comp, "--output", rec_ply,
                             "--color-space", "3dgs", "--dtype", "float32",
                             "--bucket", str(BUCKET)])
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        with open(stream_path, "rb") as f:
            rec, _ = codec.decode(FrameStream.from_bytes(f.read()), frame.codes, frame.weights)
        want = np.empty_like(rec)
        want[np.argsort(synth.morton_codes_np(V, DEPTH), kind="stable")] = rec
        q = want[:, :4]
        nq = np.linalg.norm(q, axis=1, keepdims=True)
        want[:, :4] = np.where(nq > 1e-8, q / np.maximum(nq, 1e-8), np.array([[1.0, 0, 0, 0]]))
        want[:, 4:7] = np.abs(want[:, 4:7])
        want[:, 7] = np.clip(want[:, 7], 0.0, 1.0)
        V2, A2, vsize2, _ = read_compressed_3dgs_ply(rec_ply)
        check(np.array_equal(V2, V) and vsize2 == vsize
              and np.array_equal(A2, want.astype(np.float32)),
              "the decode CLI's 3DGS PLY differs from the in-process decode")

        # a gsplat checkpoint through the loader and voxelize_3dgs --ckpt
        ck = os.path.join(tmp, "ckpt.pt")
        write_gsplat_ckpt(torch, ck, synth.gaussian_scene(N_GS_CKPT, seed=1))
        ckpt_s = run(voxelize_3dgs, ["--ckpt", ck, "--depth", str(DEPTH), "--render", "none",
                                     "--output-dir", os.path.join(tmp, "ck"),
                                     "--csv", os.path.join(tmp, "ck.csv")])
        with open(os.path.join(tmp, "ck.csv")) as f:
            ck_vox = int(list(csv.DictReader(f))[0]["N_vox"])
        check(0 < ck_vox < N_GS_CKPT, f"voxelize_3dgs --ckpt: {ck_vox} voxels")
        os.replace(comp, os.path.join(keep, "gs_vox.ply"))
    for name in SINGLE:
        check(launches[name] >= 1, f"{name} not launched on the 3DGS path")
    check(launches == {"ds_cumsum": 1, "ds_cumsum_t": 2 * (len(steps) + 1),
                       "ds_cumsum_batched": 0},
          f"scan launches on the 3DGS path {launches}")
    out["cli"] = {"nvox": nvox, "steps": len(steps), "voxelize_3dgs_ms": float(vrow["Voxel_time_ms"]),
                  "voxelize_3dgs_s": vox_s, "encode_3dgs_s": enc_s,
                  "sweep_mvox": nvox * len(steps) / enc_s / 1e6, "decode_cli_s": dec_s,
                  "ckpt_gaussians": N_GS_CKPT, "ckpt_voxels": ck_vox, "ckpt_cli_s": ckpt_s,
                  "peak_mem_gib": peak_gib, "launches": launches, "stage_s": stage_s,
                  "psnr_all": psnr, "bpp": bpp}
    say("gs_cli", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                     for k, v in out["cli"].items()})

    # the scan's wide path at its edges: one tile +1 row, one tile with a
    # ragged last column block, full column blocks only, a tile count off
    # the wave, the one-block carry's last tile count (2048) and the
    # recursive carry's first (2049), and past it
    gen = torch.Generator(device="cpu").manual_seed(2)
    for n, k in ((2049, 9), (2048, 17), (70_000, 16), ((1 << 19) + 3, 57),
                 (2048 * 2048, 12), (2048 * 2048 + 1, 12), ((1 << 22) + 5, 12)):
        x = torch.rand(n, k, generator=gen) * 3.0
        x[:, -1] = (x[:, -1] > 1.5).float()   # an integer lane
        rel, _ = check_pack(torch, ds, x.cuda())
        say("gs_wide_edges", n=n, k=k, rel_err=rel)

    # the merge's (N, 12+C) segment sums: the prefix method (the wide scan)
    # against the shift method the merge runs
    _, vals, first = merge_rows(*(torch.as_tensor(scene[k], device="cuda").float()
                                  for k in GS_KEYS), DEPTH)
    seg = {}
    for method in ("shift", "prefix"):
        torch.cuda.synchronize()
        ds.reset_launches()
        seg[method] = sorted_segment_sums(vals, first, method=method)
        torch.cuda.synchronize()
        n_scan = dict(ds.LAUNCHES)
        check(n_scan == {"ds_cumsum": int(method == "prefix"), "ds_cumsum_t": 0,
                         "ds_cumsum_batched": 0},
              f"{method}: scan launches {n_scan}")
        seg[method + "_ms"] = cuda_ms(torch, lambda: sorted_segment_sums(
            vals, first, method=method), reps=5, warm=1)
    check(int(seg["shift"][3]) == int(seg["prefix"][3]) == nvox, "segment runs")
    scale = seg["shift"][0].abs().amax(dim=0).clamp_min(1.0)
    seg_err = float(((seg["prefix"][0] - seg["shift"][0]).abs() / scale).max())
    check(seg_err <= GS_SEG_TOL, f"segment sums: prefix off the shift method by {seg_err}")
    # the packs: the transform's (sqrt(w)-scaled attributes and the weight
    # lane) as the path gives it (padded to the bucket) and at the real
    # voxel count, and the prefix method's
    from raht3dgs_tpu_torch.ops.raht import ieee_sqrt

    w = frame.weights
    body = torch.cat([ieee_sqrt(w)[:, None] * frame.attributes, w[:, None]], dim=1)
    packs = {"pack": body.contiguous(), "pack_nvox": body[:nvox].contiguous(),
             "pack_merge": vals}
    for key, x in packs.items():
        out[key] = wide_pack_row(torch, ds, x, reps=100 if key != "pack_merge" else 20)
    out["segment"] = {"shape": list(vals.shape), "shift_ms": seg["shift_ms"],
                      "prefix_ms": seg["prefix_ms"], "rel_err": seg_err, "tol": GS_SEG_TOL}
    say("gs_segment_sums", **{k: json.dumps(v) if isinstance(v, list) else v
                              for k, v in out["segment"].items()})
    for key, x in packs.items():
        add_device_ms(torch, ds, out[key], x)
        say("gs_pack", **{k: json.dumps(v) if isinstance(v, dict) else v
                          for k, v in out[key].items()})

    # the 3DGS golden fixture: the card's float64 stream is the CPU's
    pts, attrs = synth.gs_golden_fixture()
    hashes = {}
    for name, dt in (("float64", torch.float64), ("float32", torch.float32)):
        gf = tp.prepare_voxel_frame(pts, attrs, synth.GS_GOLDEN_DEPTH,
                                    bucket=synth.GS_GOLDEN_BUCKET, dtype=dt)
        blob = tp.AttributeCodec(synth.GS_GOLDEN_DEPTH, dtype=dt).encode(
            gf, synth.GS_GOLDEN_STEP).stream.to_bytes()
        hashes[name] = hashlib.sha256(blob).hexdigest()
    say("gs_golden", f64_sha256=hashes["float64"],
        f64_matches_cpu=hashes["float64"] == synth.GS_GOLDEN_SHA256["float64"],
        f32_sha256=hashes["float32"],
        f32_matches_cpu=hashes["float32"] == synth.GS_GOLDEN_SHA256["float32"])
    check(hashes["float64"] == synth.GS_GOLDEN_SHA256["float64"],
          "3DGS float64 golden stream on the card differs from the CPU hash")
    return out


def check_batched_scan(torch, ds, x):
    """The batched entry on ``x (B, N, K)``: its pack and (hi, lo) against
    each other, a second run and, frame by frame, the single entry (all
    bitwise); against its plain version (integer lanes bitwise, float lanes
    to 1e-12 relative: the two associate differently) and a float64 cumsum.
    Returns (rel. error against f64, max abs error against the plain
    version)."""
    B, N, K = x.shape
    P = ds.ds_prefix_pack_batched(x)
    hi, lo = ds.ds_cumsum_batched(x)
    R = ds.ds_prefix_pack_batched_reference(x)
    torch.cuda.synchronize()
    check(P.shape == (B, N + 1, 2 * K) and not bool(P[:, 0].any()),
          f"{tuple(x.shape)} batched pack: shape or zero rows")
    got = P[:, 1:, :K].double() + P[:, 1:, K:].double()
    ref = torch.cumsum(x.double(), 1)
    rel = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1.0)
    max_abs = float((got - (R[:, 1:, :K].double() + R[:, 1:, K:].double())).abs().max())
    check(rel < 1e-12, f"{tuple(x.shape)} batched pack: rel err {rel}")
    ints = [k for k in range(K) if bool((x[..., k] == x[..., k].round()).all())]
    for k in ints:
        check(torch.equal(P[..., k], R[..., k]) and not bool(P[..., K + k].any()),
              f"{tuple(x.shape)} batched pack: integer lane {k} differs from the plain version")
    check(torch.equal(P[:, 1:, :K], hi) and torch.equal(P[:, 1:, K:], lo),
          f"{tuple(x.shape)}: batched pack and batched (hi, lo) differ")
    check(torch.equal(P, ds.ds_prefix_pack_batched(x)), f"{tuple(x.shape)}: two runs differ")
    for b in range(B):
        check(torch.equal(P[b], ds.ds_prefix_pack(x[b])),
              f"{tuple(x.shape)}: frame {b} differs from the single entry's pack")
        h1, l1 = ds.ds_cumsum(x[b])
        check(torch.equal(hi[b], h1) and torch.equal(lo[b], l1),
              f"{tuple(x.shape)}: frame {b} differs from the single entry's (hi, lo)")
    say("dataset_scan", shape=tuple(x.shape), rel_err=rel, max_abs_err_vs_plain=max_abs,
        integer_lanes=ints, frames_equal_single_entry=B)
    return rel, max_abs


def phase_dataset(torch, ds, keep):
    """Phase 8: the dataset path. Eight seeded 8iVFBv2 frames (about 0.8 M
    voxels each at J=10) as binary PLYs in a tree under ``keep`` (phase 12
    reads it again), through
    ``cli.encode_dataset.main`` with ``--batch 4`` (two batches) and then
    as a frame loop, float32, bucket 2^19, the reference's 11 steps, with
    the scan launches read around each run; the two CSVs against each
    other; in process, one batch's ``encode_sweep`` against per-frame
    ``encode`` and its batched decode against per-frame decode, in float64
    and float32; the scan
    kernel's batched entry at the path's (4, 2^20, 4) pack, on the wide
    path at (2, 2^19, 9) and (3, 2^19, 57), and past the one-block carry,
    then timed."""
    import contextlib
    import csv
    import math
    import os

    import numpy as np

    from raht3dgs_tpu_torch.cli import encode_dataset
    from raht3dgs_tpu_torch.config import ColorCodecConfig
    from raht3dgs_tpu_torch.io.datasets import frame_path, get_pointcloud
    from raht3dgs_tpu_torch.models import pipeline as tp
    from raht3dgs_tpu_torch.models.batch_codec import BatchAttributeCodec, prepare_frame_batch
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv
    from raht3dgs_tpu_torch.ops.raht import ieee_sqrt
    from raht3dgs_tpu_torch.utils import synth

    steps = list(ColorCodecConfig.steps)
    n_batches = -(-N_FRAMES // BATCH)
    out = {}
    with contextlib.nullcontext(os.path.join(keep, "dataset")) as tmp:
        t0 = time.perf_counter()
        nvox = []
        for f in range(N_FRAMES):
            V, rgb = synth.dataset_frame(f)
            path = frame_path("8iVFBv2", "loot", f + 1, tmp)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            synth.write_binary_ply(path, V.astype(np.float32), rgb.astype(np.uint8),
                                   width=(1 << DEPTH) - 1)
            nvox.append(len(V))
        check(all(NVOX_FRAME_RANGE[0] <= n <= NVOX_FRAME_RANGE[1] for n in nvox)
              and len(set(nvox)) > 1, f"dataset frames hold {nvox} voxels")
        say("dataset", frames=N_FRAMES, nvox=json.dumps(nvox),
            generate_s=time.perf_counter() - t0)

        runs = {}
        for mode, extra in (("batch", ["--batch", str(BATCH)]), ("loop", [])):
            csv_path = os.path.join(tmp, f"{mode}.csv")
            argv = ["--dataset", "8iVFBv2", "--sequence", "loot", "--data-root", tmp,
                    "--frames", "1", str(N_FRAMES), "--dtype", "float32", "--bucket",
                    str(BUCKET), "--csv", csv_path, "--steps", *[f"{s:g}" for s in steps],
                    *extra]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ds.reset_launches()
            t0 = time.perf_counter()
            check(encode_dataset.main(argv) == 0, f"encode_dataset ({mode}) failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ds.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30
            with open(csv_path) as f:
                rows = list(csv.DictReader(f))
            check(len(rows) == N_FRAMES * len(steps), f"{mode}: {len(rows)} CSV rows")
            runs[mode] = {(int(r["Frame"]), float(r["Quantization_Step"])): r for r in rows}
            check(len(runs[mode]) == len(rows), f"{mode}: repeated CSV rows")
            for fr in range(1, N_FRAMES + 1):
                psnr = [float(runs[mode][(fr, s)]["psnr"]) for s in steps]
                check(all(math.isfinite(p) for p in psnr)
                      and all(a >= b for a, b in zip(psnr, psnr[1:])),
                      f"{mode}: frame {fr} PSNR {psnr}")
            out[mode] = {"wall_s": wall,
                         "sweep_mpts": sum(nvox) * len(steps) / wall / 1e6,
                         "peak_mem_gib": peak, "launches": launches,
                         "stage_s": {k: sum(float(r[k]) for r in rows)
                                     for k in list(rows[0])[3:10]}}
            say("dataset_cli", mode=mode, **{k: json.dumps(v) if isinstance(v, dict) else v
                                             for k, v in out[mode].items()})
        check(out["batch"]["launches"] == {"ds_cumsum": 0, "ds_cumsum_t": 0,
                                           "ds_cumsum_batched": n_batches * (2 + len(steps))},
              f"scan launches of the batched run {out['batch']['launches']}")
        check(out["loop"]["launches"] == {"ds_cumsum": N_FRAMES,
                                          "ds_cumsum_t": N_FRAMES * 2 * len(steps),
                                          "ds_cumsum_batched": 0},
              f"scan launches of the frame loop {out['loop']['launches']}")
        for key, row in runs["batch"].items():
            check(row["Rate_bpp"] == runs["loop"][key]["Rate_bpp"],
                  f"frame {key[0]} step {key[1]:g}: batched rate {row['Rate_bpp']} != "
                  f"frame loop {runs['loop'][key]['Rate_bpp']}")

        # one batch in process, float64 (the CLI's default) and float32 (the
        # runs above): the sweep against per-frame encode, byte for byte, and
        # the batched decode against per-frame decode
        loaded = [get_pointcloud("8iVFBv2", "loot", f + 1, tmp) for f in range(BATCH)]
    pos = [np.floor(v).astype(np.int64) for v, _, _ in loaded]
    for dt in (torch.float64, torch.float32):
        yuv = [rgb_to_yuv(torch.as_tensor(c, device="cuda"), dtype=dt).cpu().numpy()
               for _, c, _ in loaded]
        frames = prepare_frame_batch(pos, yuv, DEPTH, bucket=BUCKET, dtype=dt)
        bc = BatchAttributeCodec(DEPTH, dtype=dt)
        codec = tp.AttributeCodec(DEPTH, dtype=dt)
        coeffs, orderp, _ = bc.transform(frames)
        sweep = bc.encode_sweep(frames, steps, coeffs=coeffs, orderp=orderp)
        inv = bc.inverse_order(frames)
        for fi, f in enumerate(frames):
            c, o, _, _ = codec.transform(f)
            for s, (streams, _) in zip(steps, sweep):
                blob = streams[fi].to_bytes()
                check(blob == codec.encode(f, s, coeffs=c, order=o).stream.to_bytes(),
                      f"{dt} frame {fi + 1} step {s:g}: encode_sweep bytes != per-frame encode")
                if dt == torch.float32:
                    check(f"{streams[fi].bpp():.6f}" == runs["batch"][(fi + 1, s)]["Rate_bpp"],
                          f"frame {fi + 1} step {s:g}: the CLI's rate differs from the stream's")
        for si in (0, len(steps) - 1):
            recs, _ = bc.decode(sweep[si][0], frames, inv=inv)
            for f, stream, rec in zip(frames, sweep[si][0], recs):
                want, _ = codec.decode(stream, f.codes, f.weights)
                check(np.array_equal(rec, want),
                      f"{dt} step {steps[si]:g}: batched decode != decode")
        say("dataset", dtype=str(dt).removeprefix("torch."),
            sweep_bytes_equal_encode=BATCH * len(steps), decode_equal=2 * BATCH,
            frames_padded_to=int(frames[0].codes.shape[0]))
        del coeffs, orderp, sweep, inv

    # the batched entry at the path's forward pack (the float32 frames), and
    # the wide path
    w = torch.stack([f.weights for f in frames])
    body = torch.cat([ieee_sqrt(w)[..., None] * torch.stack([f.attributes for f in frames]),
                      w[..., None]], dim=2).contiguous()
    del frames
    B, N, K = body.shape
    padded = -(-max(nvox[:BATCH]) // BUCKET) * BUCKET   # 2^20 at 0.8 M voxels
    check((B, N, K) == (BATCH, padded, D_ATTR + 1), f"the path's pack is {(B, N, K)}")
    rel, max_abs = check_batched_scan(torch, ds, body)
    # the wide path, and both paths past the one-block carry (2048 tiles)
    gen = torch.Generator(device="cpu").manual_seed(3)
    for shape in ((2, 1 << 19, 9), (3, 1 << 19, 57), (2, (1 << 22) + 5, 4),
                  (2, (1 << 22) + 5, 12)):
        x = torch.rand(*shape, generator=gen) * 3.0
        x[..., -1] = (x[..., -1] > 1.5).float()   # an integer lane
        check_batched_scan(torch, ds, x.cuda())
    del x

    ms = cuda_ms(torch, lambda: ds.ds_prefix_pack_batched(body), reps=100)
    single_ms = cuda_ms(torch, lambda: [ds.ds_prefix_pack(body[b]) for b in range(B)], reps=100)
    plain_ms = cuda_ms(torch, lambda: ds.ds_prefix_pack_batched_reference(body), reps=3, warm=1)
    lib_ms = cuda_ms(torch, lambda: torch.cumsum(body, 1, dtype=torch.float64), reps=5, warm=1)
    bytes_ms = 4.0 * (B * N * K + B * (N + 1) * 2 * K) / HBM_BYTES_PER_S * 1e3
    ops_ms = DS_OPS_PER_ELEM * B * N * K / F32_OPS_PER_S * 1e3
    row = {
        "name": "ds_cumsum_batched", "route": "cuda", "source": SOURCE["ds_cumsum_batched"],
        "replaces": REPLACES["ds_cumsum_batched"],
        "launches": out["batch"]["launches"]["ds_cumsum_batched"], "max_abs_err": max_abs,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": lib_ms,
        "call": "ds_prefix_pack_batched", "shape": [B, N, K], "rel_err": rel,
        "single_entry_ms": single_ms, **fair_library_ms(torch, body, reps=5),
    }
    row["device_ms"], row["device_launches_per_call"], row["device_us_by_kernel"] = \
        device_ms(torch, lambda: ds.ds_prefix_pack_batched(body))
    row["single_entry_device_ms"], _, _ = device_ms(
        torch, lambda: [ds.ds_prefix_pack(body[b]) for b in range(B)])
    say("dataset_kernel", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                             for k, v in row.items()})
    out["row"] = row
    out["nvox"] = nvox
    # the frame loop's rate at each step, by frame (phase 12's targets)
    out["loop_bpp"] = {fr: [float(runs["loop"][(fr, s)]["Rate_bpp"]) for s in steps]
                       for fr in range(1, N_FRAMES + 1)}
    out["root"] = tmp
    return out



def random_splats(np, rng, n, sh_k):
    """``n`` random Gaussians in [-1, 1]^3 with ``sh_k`` SH coefficients."""
    return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 4)).astype(np.float32),
            rng.uniform(0.01, 0.06, (n, 3)).astype(np.float32),
            rng.uniform(0.2, 1.0, n).astype(np.float32),
            rng.normal(0, 0.5, (n, 3 * sh_k)).astype(np.float32))


def scene_cameras(np, means, n_views, size):
    """The render comparison's cameras for a scene (``render.py``)."""
    from raht3dgs_tpu_torch.eval.cameras import generate_random_cameras

    radius = float((means.max(axis=0) - means.min(axis=0)).max()) * 1.5
    return generate_random_cameras(means.mean(axis=0), radius, n_views, size, size, seed=0)


def render_checks(torch):
    """Phase 9 (a): the tiled rasterizer on the card against the dense one,
    against the port's CPU run of the same call, and its early exit
    bitwise against a run of every chunk."""
    import numpy as np

    from raht3dgs_tpu_torch.eval import rasterize as tr
    from raht3dgs_tpu_torch.utils import synth

    out = {}
    rng = np.random.default_rng(9)
    viewmat = np.eye(4, dtype=np.float32)
    viewmat[2, 3] = 3.0
    K = np.array([[76.8, 0, 32], [0, 76.8, 32], [0, 0, 1]], np.float32)
    for deg in (0, 3):
        scene = random_splats(np, rng, N_RENDER_DENSE, (deg + 1) ** 2)
        img, meta = tr.rasterize_gaussians(*scene, viewmat, K, 64, 64, max_per_tile=4096)
        dense = tr.rasterize_dense(*scene, viewmat, K, 64, 64)
        err = float(np.abs(img - dense).max())
        counts = (int(meta.dup_clipped), int(meta.tile_clipped))
        check(meta.dup_clipped.device.type == CARD, "the rasterizer ran off the card")
        check(counts == (0, 0) and err <= RENDER_DENSE_TOL,
              f"SH degree {deg}: tiled against dense {err}, counters {counts}")
        out[f"dense_sh{deg}_err"] = err

    # the early exit against every chunk: wide opaque splats stacked in depth
    # (every pixel saturates), and the SH degree 3 scene (exits when spent)
    n = 400
    stack = (rng.normal(0, 0.05, (n, 3)).astype(np.float32), np.tile(
        np.array([1, 0, 0, 0], np.float32), (n, 1)), np.full((n, 3), 2.0, np.float32),
        np.full(n, 0.99, np.float32), rng.normal(0, 0.5, (n, 3)).astype(np.float32))
    stack[0][:, 2] = np.linspace(-0.5, 0.5, n, dtype=np.float32)
    for name, sc in (("stack", stack), ("sh3", scene)):
        t = [torch.as_tensor(x, device=CARD) for x in (*sc, viewmat, K)]
        sh, deg = tr._colors_to_sh(t[4])
        kw = dict(width=64, height=64, sh_degree=deg, tile=16, max_tiles_per_gauss=32,
                  max_per_tile=4096, chunk=16)
        args = (*t[:4], sh, t[5], t[6], torch.ones(3, device=CARD))
        tr.reset_counts()
        early, _ = tr._rasterize_tiled(*args, **kw)
        c_early = tr.COUNTS["chunks"]
        full, _ = tr._rasterize_tiled(*args, early_exit=False, **kw)
        c_full = tr.COUNTS["chunks"] - c_early
        check(torch.equal(early, full), f"{name}: the early exit changed the image")
        check(c_early < c_full or name != "stack", f"{name}: no early exit ({c_early})")
        out[f"early_exit_{name}_chunks"] = [c_early, c_full]

    # the card against the CPU on a gaussian_scene, with room for every
    # entry (at 4096 a tile would clip, and one cull decision rounded apart
    # would change which entries a tile keeps)
    gs = synth.gaussian_scene(N_RENDER_CPU, seed=0)
    vms, Ks, W, H = scene_cameras(np, gs["means"], 2, 128)
    errs = []
    for v in range(2):
        args = (*(gs[k] for k in ("means", "quats", "scales", "opacities", "colors")), vms[v],
                Ks[v], W, H)
        g_img, g_meta = tr.rasterize_gaussians(*args, max_per_tile=16384)
        c_img, c_meta = tr.rasterize_gaussians(*args, max_per_tile=16384, device="cpu")
        counts = [(int(m.dup_clipped), int(m.tile_clipped)) for m in (g_meta, c_meta)]
        errs.append(float(np.abs(g_img - c_img).max()))
        check(counts[0] == counts[1] and errs[-1] <= RENDER_CPU_TOL,
              f"view {v}: card against CPU {errs[-1]}, counters {counts}")
    out.update(cpu_err=errs, cpu_counters=counts[0])
    say("render_checks", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                            for k, v in out.items()})
    return out


def colour_max(torch, params, viewmats) -> float:
    """The largest SH colour any Gaussian of the scene takes in these views:
    a blended pixel is a convex combination of colours and the white
    background, so no pixel exceeds max(1, this)."""
    from raht3dgs_tpu_torch.eval import rasterize as tr

    f32 = torch.float32
    means = torch.as_tensor(params["means"], dtype=f32, device=CARD)
    sh, deg = tr._colors_to_sh(torch.as_tensor(params["colors"], dtype=f32, device=CARD))
    top = 0.0
    for vm in viewmats:
        R = torch.as_tensor(vm[:3, :3], dtype=f32, device=CARD)
        t = torch.as_tensor(vm[:3, 3], dtype=f32, device=CARD)
        d = means + R.T @ t
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True), min=1e-12)
        top = max(top, float(tr.eval_sh(sh, d, deg).max()))
    return top


def phase_render(torch, ds):
    """Phase 9: the render comparison. (a) :func:`render_checks`; (b) at full
    width, the three 3DGS CLIs' render paths from PLYs in a temporary
    directory, each asserting the backend, the device, finite PSNRs and the
    pixel range; then every view of the 2e6-Gaussian scene and of its
    487 180-voxel merge timed (CUDA events, a warm-up first) with its
    retries, overflow counts, chunks, syncs and peak memory."""
    import contextlib
    import csv
    import math
    import os
    import tempfile
    import warnings

    import numpy as np

    from raht3dgs_tpu_torch.cli import encode_3dgs, encode_3dgs_debug, voxelize_3dgs
    from raht3dgs_tpu_torch.config import GsCodecConfig
    from raht3dgs_tpu_torch.eval import rasterize as tr, render as trr
    from raht3dgs_tpu_torch.io.ply import read_compressed_3dgs_ply, save_ply_3dgs
    from raht3dgs_tpu_torch.models.gs_voxelize import GS_KEYS
    from raht3dgs_tpu_torch.utils import synth

    out = {"checks": render_checks(torch)}
    rec = {"metas": [], "images": [], "results": []}
    originals = (tr.rasterize_gaussians, trr.volumetric_render, trr.render_comparison)

    def raster(*a, **k):
        img, meta = originals[0](*a, **k)
        rec["metas"].append((meta.dup_clipped.device.type, int(meta.dup_clipped),
                             int(meta.tile_clipped), k["max_tiles_per_gauss"],
                             k["max_per_tile"]))
        return img, meta

    def volumetric(params, viewmats, *a, **k):
        imgs = originals[1](params, viewmats, *a, **k)
        rec["images"].append((float(imgs.min()), float(imgs.max()),
                              max(1.0, colour_max(torch, params, viewmats))))
        return imgs

    def compare(*a, **k):
        res = originals[2](*a, **k)
        rec["results"].append(res)
        return res

    @contextlib.contextmanager
    def recorded(images=True):
        """Record every rasterized view's overflow counts and, with
        ``images``, every comparison and its pixel range (which costs a pass
        over the scene: not inside a timed region)."""
        for r in rec.values():
            r.clear()
        tr.rasterize_gaussians = raster
        if images:
            trr.volumetric_render, trr.render_comparison = volumetric, compare
        try:
            yield
        finally:
            tr.rasterize_gaussians, trr.volumetric_render, trr.render_comparison = originals

    def run(name, cli, argv):
        """One CLI run, recorded: its wall, scan launches, peak memory, and
        every render comparison's backend, devices, PSNRs and pixel range."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ds.reset_launches()
        tr.reset_counts()
        with recorded(), warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            check(cli.main(argv) == 0, f"{name} failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        check(rec["results"] and all(r.get("backend") == "jax" for r in rec["results"]),
              f"{name}: backends {[r.get('backend') for r in rec['results']]}")
        check({m[0] for m in rec["metas"]} == {CARD}, f"{name}: rasterized off the card")
        psnrs = [r["psnr_per_view"] for r in rec["results"]]
        check(all(math.isfinite(p) for v in psnrs for p in v), f"{name}: PSNR {psnrs}")
        for lo, hi, top in rec["images"]:
            check(lo >= 0.0 and hi <= top + PIXEL_TOL, f"{name}: pixels in [{lo}, {hi}], "
                  f"colours up to {top}")
        row = {"wall_s": wall, "psnr_avg": [r["psnr_avg"] for r in rec["results"]],
               "psnr_per_view": psnrs, "launches": dict(ds.LAUNCHES),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "views": tr.COUNTS["views"], "chunks": tr.COUNTS["chunks"],
               "syncs": tr.COUNTS["syncs"],
               "render_ms": [[r["original_render_time_ms"], r["merged_render_time_ms"]]
                             for r in rec["results"]],
               "pixels": [list(x) for x in rec["images"]],
               "overflow_warnings": [str(w.message) for w in warned
                                     if "overflow" in str(w.message)]}
        say(f"render_{name}", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                                 for k, v in row.items()})
        return row

    scene = synth.gaussian_scene(N_GS, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        scene_ply = os.path.join(tmp, "scene.ply")
        save_ply_3dgs(scene_ply, *(scene[k] for k in GS_KEYS))
        odir = os.path.join(tmp, "vox")
        comp = os.path.join(odir, "compressed_Nvox_gaussians.ply")
        out["voxelize_3dgs"] = run("voxelize_3dgs", voxelize_3dgs, [
            "--ply", scene_ply, "--depth", str(DEPTH), "--output-dir", odir,
            "--csv", os.path.join(tmp, "vox.csv")])
        with open(os.path.join(tmp, "vox.csv")) as f:
            nvox = int(list(csv.DictReader(f))[0]["N_vox"])
        check(nvox == GS_NVOX, f"voxelize_3dgs: {nvox} voxels")
        check(len(rec["results"]) == 1 and len(rec["results"][0]["psnr_per_view"])
              == RENDER_VIEWS and rec["images"] and len(rec["metas"]) >= 2 * RENDER_VIEWS,
              "voxelize_3dgs: not one comparison of 5 views a scene")
        enc_argv = ["--input", comp, "--depth", str(DEPTH), "--dtype", "float32",
                    "--bucket", str(BUCKET), "--csv", os.path.join(tmp, "gs.csv")]
        out["encode_3dgs"] = run("encode_3dgs", encode_3dgs, enc_argv + ["--render", "auto"])
        out["encode_3dgs_debug"] = run("encode_3dgs_debug", encode_3dgs_debug, [
            "--input", comp, "--depth", str(DEPTH), "--dtype", "float32", "--bucket",
            str(BUCKET), "--ablation", "--image-size", str(ABLATION_SIZE)])
        check(len(rec["results"]) == 4, "the ablation: not one comparison a group")
        V, A, vsize, vmin = read_compressed_3dgs_ply(comp)

    n_steps = len(GsCodecConfig.steps)
    check(out["voxelize_3dgs"]["launches"] == {"ds_cumsum": 0, "ds_cumsum_t": 0,
                                               "ds_cumsum_batched": 0}
          and out["encode_3dgs"]["launches"] == {"ds_cumsum": 1,
                                                 "ds_cumsum_t": 2 * (n_steps + 1),
                                                 "ds_cumsum_batched": 0}
          and out["encode_3dgs_debug"]["launches"] == {"ds_cumsum": 1, "ds_cumsum_t": 2,
                                                       "ds_cumsum_batched": 0},
          "scan launches on the render paths")

    # every view of both scenes, timed one at a time on a scene already on
    # the card, with its retries and what they left
    merged = {"means": (V.astype(np.float64) + 0.5) * vsize + vmin, "quats": A[:, 0:4],
              "scales": A[:, 4:7], "opacities": A[:, 7], "colors": A[:, 8:]}
    vms, Ks, W, H = scene_cameras(np, scene["means"], RENDER_VIEWS, RENDER_SIZE)
    out["views"] = {}
    for name, params in (("original_2e6", scene), ("merged_487k", merged)):
        on_card = {k: torch.as_tensor(params[k], dtype=torch.float32, device=CARD)
                   for k in GS_KEYS}
        rows = []
        with recorded(images=False), warnings.catch_warnings():
            warnings.simplefilter("ignore")   # overflow after the retries is counted below
            trr.volumetric_render(on_card, vms[:1], Ks[:1], W, H)   # warm-up
            for v in range(RENDER_VIEWS):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                tr.reset_counts()
                n0 = len(rec["metas"])
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                trr.volumetric_render(on_card, vms[v:v + 1], Ks[v:v + 1], W, H)
                end.record()
                end.synchronize()
                metas = rec["metas"][n0:]
                rows.append({"ms": start.elapsed_time(end), "retries": len(metas) - 1,
                             "dup_clipped": metas[-1][1], "tile_clipped": metas[-1][2],
                             "caps": list(metas[-1][3:]), "chunks": tr.COUNTS["chunks"],
                             "syncs": tr.COUNTS["syncs"],
                             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
        del on_card
        out["views"][name] = rows
        say("render_views", scene=name, n=len(params["means"]), size=RENDER_SIZE,
            ms=json.dumps([r["ms"] for r in rows]),
            retries=json.dumps([r["retries"] for r in rows]),
            dup_clipped=json.dumps([r["dup_clipped"] for r in rows]),
            tile_clipped=json.dumps([r["tile_clipped"] for r in rows]),
            caps=json.dumps([r["caps"] for r in rows]),
            chunks=json.dumps([r["chunks"] for r in rows]),
            syncs=json.dumps([r["syncs"] for r in rows]),
            peak_mem_gib=json.dumps([r["peak_mem_gib"] for r in rows]))
    return out


def host_ms(fn, reps: int = 5) -> float:
    """Median wall time of a host call in ms (one warm-up first)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_entropy(torch, ds, cli, gs, keep):
    """Phase 10: the RAC and geometry coders. ``encode_ply --code-geometry
    --entropy auto`` on phase 6's raw cloud (one ext3 geometry section on
    every step's stream, every channel no larger than phase 6's RLGR
    stream, the same PSNRs), ``decode`` of one stream without and with
    ``--positions`` (the same rows), a wrong positions file and
    ``--geometry-lod 6``; ``encode_3dgs --code-geometry --entropy rac`` on
    phase 7's merged scene and its decode without positions against the
    one given the PLY; the golden fixture's RAC and auto hashes; the
    coders' host times, with the scan launches read around each CLI run."""
    import contextlib
    import csv
    import io
    import os

    import numpy as np

    from raht3dgs_tpu_torch.cli import decode, encode_3dgs, encode_ply
    from raht3dgs_tpu_torch.codec import geometry as tg
    from raht3dgs_tpu_torch.codec.bitstream import FrameStream
    from raht3dgs_tpu_torch.codec.rac import (
        rac_decode,
        rac_decode_channels,
        rac_encode,
        rac_encode_channels,
    )
    from raht3dgs_tpu_torch.codec.rlgr import (
        rlgr_decode,
        rlgr_decode_channels,
        rlgr_encode,
        rlgr_encode_channels,
    )
    from raht3dgs_tpu_torch.config import ColorCodecConfig, GsCodecConfig
    from raht3dgs_tpu_torch.io.ply import read_compressed_3dgs_ply, read_ply, read_ply_8i
    from raht3dgs_tpu_torch.models import pipeline as tp
    from raht3dgs_tpu_torch.ops.morton import morton_codes_np
    from raht3dgs_tpu_torch.utils import synth

    t_phase = time.perf_counter()
    out = {}
    launches = {"colour": {name: 0 for name in ds.LAUNCHES},
                "gs": {name: 0 for name in ds.LAUNCHES}}

    def run(path, fn, *args):
        """``fn(*args)`` with the scan launches added to ``path``; its wall."""
        torch.cuda.synchronize()
        ds.reset_launches()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k, v in ds.LAUNCHES.items():
            launches[path][k] += v
        return wall

    def main_of(cli, argv):
        check(cli.main(argv) == 0, f"{cli.__name__} {argv[-2:]} failed")

    def sorted_rows(V, *cols):
        order = np.argsort(morton_codes_np(np.asarray(V).astype(np.int64), DEPTH),
                           kind="stable")
        return [np.asarray(c)[order] for c in (V, *cols)]

    steps = list(ColorCodecConfig.steps)
    raw, pos_ply = os.path.join(keep, "raw.ply"), os.path.join(keep, "pos.ply")
    sdir, csv_path = os.path.join(keep, "auto"), os.path.join(keep, "auto.csv")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        enc_s = run("colour", main_of, encode_ply, [
            "--input", raw, "--voxelize", "--depth", str(DEPTH), "--dtype", "float32",
            "--bucket", str(BUCKET), "--save-streams", sdir, "--csv", csv_path,
            "--code-geometry", "--entropy", "auto", "--steps", *[f"{s:g}" for s in steps]])
    geo_line = [ln for ln in buf.getvalue().splitlines() if "bits/voxel" in ln]
    check(len(geo_line) == 1, f"encode_ply printed {geo_line}")
    check(launches["colour"] == {"ds_cumsum": 1, "ds_cumsum_t": 2 * len(steps),
                                 "ds_cumsum_batched": 0},
          f"encode_ply --entropy auto: scan launches {launches['colour']}")
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    psnr = [float(r["psnr"]) for r in rows]
    check(psnr == cli["psnr"], f"auto's PSNR {psnr} != RLGR's {cli['psnr']}")
    geom, auto_bytes = None, []
    for k, s in enumerate(steps):
        with open(os.path.join(sdir, f"frame0001_step{s:g}.r3tc"), "rb") as f:
            st = FrameStream.from_bytes(f.read())
        check(st.geometry is not None and st.geometry[0] == 3,
              f"step {s:g}: geometry section profile "
              f"{None if st.geometry is None else st.geometry[0]}")
        check(geom is None or st.geometry == geom, f"step {s:g}: another geometry section")
        geom = st.geometry
        got = [len(c) for c in st.channels]
        check(all(a <= b for a, b in zip(got, cli["channel_bytes"][k])),
              f"step {s:g}: auto {got} > RLGR {cli['channel_bytes'][k]} bytes")
        auto_bytes.append(got)
        if s == STEP:
            st16 = st
    nvox = st16.n_voxels
    out["colour"] = {"nvox": nvox, "geometry_bits_per_voxel": len(geom) * 8.0 / nvox,
                     "encode_ply_s": enc_s, "psnr_equal_rlgr": len(steps),
                     "auto_bytes": auto_bytes, "rlgr_bytes": cli["channel_bytes"]}

    # decode of the step-16 stream without and with --positions
    s16 = os.path.join(sdir, f"frame0001_step{STEP:g}.r3tc")
    own, given = os.path.join(keep, "own.ply"), os.path.join(keep, "given.ply")
    dec_argv = ["--stream", s16, "--dtype", "float32", "--bucket", str(BUCKET)]
    with contextlib.redirect_stdout(io.StringIO()):
        own_s = run("colour", main_of, decode, dec_argv + ["--output", own])
        given_s = run("colour", main_of, decode,
                      dec_argv + ["--positions", pos_ply, "--output", given])
    Va, Ca, _ = read_ply_8i(own)
    Vb, Cb = sorted_rows(*read_ply_8i(given)[:2])
    check(np.array_equal(Va, Vb) and np.array_equal(Ca, Cb),
          "decode without --positions differs from the decode with them")
    check(len(Va) == nvox, f"decode without --positions wrote {len(Va)} rows")
    # a positions file with one voxel moved to a free cell exits
    V = Va.astype(np.int64)
    occupied = set(morton_codes_np(V, DEPTH).tolist())
    free = next(x for x in range(1 << DEPTH)
                if int(morton_codes_np(np.array([[x, 0, 0]]), DEPTH)[0]) not in occupied)
    V[0] = [free, 0, 0]
    wrong = os.path.join(keep, "wrong.ply")
    synth.write_binary_ply(wrong, V.astype(np.float32))
    try:
        decode.main(dec_argv + ["--positions", wrong, "--output", os.path.join(keep, "x.ply")])
        check(False, "a moved voxel decoded")
    except SystemExit as e:
        check("does not match the geometry" in str(e), f"moved voxel: {e}")
    lod = os.path.join(keep, "lod.ply")
    with contextlib.redirect_stdout(io.StringIO()):
        lod_s = run("colour", main_of, decode, ["--stream", s16, "--output", lod,
                                                "--geometry-lod", "6"])
    cells = tg.decode_geometry_lod(geom, DEPTH, nvox, 6)
    check(len(read_ply(lod).vertices) == len(cells), "--geometry-lod 6 cell count")
    check(launches["colour"] == {"ds_cumsum": 1, "ds_cumsum_t": 2 * (len(steps) + 2),
                                 "ds_cumsum_batched": 0},
          f"colour entropy path: scan launches {launches['colour']}")
    out["colour"].update(decode_without_positions_s=own_s, decode_with_positions_s=given_s,
                         geometry_lod6_s=lod_s, geometry_lod6_cells=len(cells),
                         launches=launches["colour"])

    # the coders' host times at this frame: geometry (ext3 and legacy), and
    # RAC against RLGR on the step-16 symbols, per channel and whole frame
    codes = tg.decode_geometry(geom, DEPTH, nvox)
    timing = {}
    for name, ext3 in (("ext3", True), ("legacy", False)):
        blob = tg.encode_geometry(codes, DEPTH, ext3=ext3)
        check(np.array_equal(tg.decode_geometry(blob, DEPTH, nvox), codes),
              f"geometry {name} round trip")
        timing[f"geometry_{name}"] = {
            "bits_per_voxel": len(blob) * 8.0 / nvox,
            "encode_ms": host_ms(lambda: tg.encode_geometry(codes, DEPTH, ext3=ext3)),
            "decode_ms": host_ms(lambda: tg.decode_geometry(blob, DEPTH, nvox))}
    check(tg.encode_geometry(codes, DEPTH) == geom, "the CLI's section != encode_geometry")
    q = np.zeros((st16.n_channels, nvox), np.int32)
    tp.decode_entropy_channels(st16, nvox, q)
    coders = {}
    for name, enc, dec in (
            ("rlgr", lambda x: rlgr_encode(x)[0],
             lambda b, o: rlgr_decode(b, nvox, out=o)),
            ("rac", lambda x: rac_encode(x)[0], lambda b, o: rac_decode(b, nvox, out=o))):
        row = {"channel_bytes": [], "channel_encode_ms": [], "channel_decode_ms": []}
        for d in range(q.shape[0]):
            blob = enc(q[d])
            o = np.empty(nvox, np.int32)
            dec(blob, o)
            check(np.array_equal(o, q[d]), f"{name} channel {d} round trip")
            row["channel_bytes"].append(len(blob))
            row["channel_encode_ms"].append(host_ms(lambda: enc(q[d])))
            row["channel_decode_ms"].append(host_ms(lambda: dec(blob, o)))
        coders[name] = row
    frame_enc = {"rlgr": lambda: rlgr_encode_channels(q, channel_major=True)[0],
                 "rac": lambda: rac_encode_channels(q, channel_major=True)[0]}
    for name, fn in frame_enc.items():
        blobs = fn()
        o = np.zeros_like(q)
        dec = ((lambda: rlgr_decode_channels(blobs, nvox, out=o)) if name == "rlgr"
               else (lambda: rac_decode_channels(blobs, nvox, o)))
        dec()
        check(np.array_equal(o, q), f"{name} frame round trip")
        coders[name].update(frame_encode_ms=host_ms(fn), frame_decode_ms=host_ms(dec),
                            frame_bytes=sum(len(b) for b in blobs))
    # RAC alone over the sweep, beside auto's and RLGR's bytes: each step's
    # symbols from its auto stream, coded again
    rac_bytes = []
    for s in steps:
        with open(os.path.join(sdir, f"frame0001_step{s:g}.r3tc"), "rb") as f:
            st = FrameStream.from_bytes(f.read())
        qs = np.zeros((st.n_channels, nvox), np.int32)
        tp.decode_entropy_channels(st, nvox, qs)
        rac_bytes.append([len(b) for b in rac_encode_channels(qs, channel_major=True)[0]])
    check(all(a <= b for ab, rb in zip(auto_bytes, rac_bytes) for a, b in zip(ab, rb)),
          f"auto {auto_bytes} > RAC {rac_bytes} bytes")
    out["colour"]["rac_bytes"] = rac_bytes
    timing["coders"] = coders
    out["colour"]["timing"] = timing
    say("entropy_colour", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                             for k, v in out["colour"].items()})

    # 3DGS: encode_3dgs --code-geometry --entropy rac, decode without positions
    gsteps = list(GsCodecConfig.steps)
    comp = os.path.join(keep, "gs_vox.ply")
    gdir, gcsv = os.path.join(keep, "gs_rac"), os.path.join(keep, "gs_rac.csv")
    with contextlib.redirect_stdout(io.StringIO()):
        genc_s = run("gs", main_of, encode_3dgs, [
            "--input", comp, "--depth", str(DEPTH), "--dtype", "float32", "--bucket",
            str(BUCKET), "--render", "none", "--save-streams", gdir, "--csv", gcsv,
            "--code-geometry", "--entropy", "rac", "--steps", *[f"{s:g}" for s in gsteps]])
    with open(gcsv) as f:
        grows = list(csv.DictReader(f))
    gpsnr = [float(r["PSNR_all"]) for r in grows]
    check(gpsnr == gs["cli"]["psnr_all"], f"RAC 3DGS PSNR {gpsnr} != RLGR's")
    gbpp = [float(r["Rate_bpp"]) for r in grows]
    gstream = os.path.join(gdir, f"gs_step{min(gsteps):g}.r3tc")
    with open(gstream, "rb") as f:
        gst = FrameStream.from_bytes(f.read())
    check(gst.entropy_map == (True,) * gst.n_channels and gst.geometry[0] == 3,
          "the 3DGS stream is not RAC with an ext3 geometry section")
    gown, ggiven = os.path.join(keep, "gs_own.ply"), os.path.join(keep, "gs_given.ply")
    gargv = ["--stream", gstream, "--color-space", "3dgs", "--dtype", "float32",
             "--bucket", str(BUCKET)]
    with contextlib.redirect_stdout(io.StringIO()):
        gown_s = run("gs", main_of, decode, gargv + ["--output", gown])
        ggiven_s = run("gs", main_of, decode, gargv + ["--positions", comp, "--output", ggiven])
    Va, Aa, vsa, vmina = read_compressed_3dgs_ply(gown)
    Vb, Ab, vsb, vminb = read_compressed_3dgs_ply(ggiven)
    Vb, Ab = sorted_rows(Vb, Ab)
    check(np.array_equal(Va, Vb) and np.array_equal(Aa, Ab) and vsa == vsb
          and np.array_equal(vmina, vminb),
          "3DGS decode without --positions differs from the decode with them")
    check(launches["gs"] == {"ds_cumsum": 1, "ds_cumsum_t": 2 * (len(gsteps) + 2),
                             "ds_cumsum_batched": 0},
          f"3DGS entropy path: scan launches {launches['gs']}")
    out["gs"] = {"nvox": gst.n_voxels, "encode_3dgs_s": genc_s,
                 "geometry_bits_per_voxel": gst.geometry_bpp(), "bpp_rac": gbpp,
                 "bpp_rlgr": gs["cli"]["bpp"], "decode_without_positions_s": gown_s,
                 "decode_with_positions_s": ggiven_s, "launches": launches["gs"]}
    say("entropy_gs", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                         for k, v in out["gs"].items()})

    # the golden fixture under rac and auto, float64, geometry attached
    pts, attrs = synth.golden_fixture()
    hashes = {}
    for entropy in ("rac", "auto"):
        frame = tp.prepare_voxel_frame(pts, attrs, synth.GOLDEN_DEPTH,
                                       bucket=synth.GOLDEN_BUCKET, dtype=torch.float64)
        st = tp.AttributeCodec(synth.GOLDEN_DEPTH, dtype=torch.float64,
                               entropy=entropy).encode(frame, steps=synth.GOLDEN_STEP).stream
        st.geometry = tg.geometry_from_positions(pts, synth.GOLDEN_DEPTH)
        hashes[entropy] = hashlib.sha256(st.to_bytes()).hexdigest()
        check(hashes[entropy] == synth.GOLDEN_ENTROPY_SHA256[entropy],
              f"{entropy} golden stream on the card differs from the CPU hash")
    say("entropy_golden", **{f"{k}_sha256": v for k, v in hashes.items()}, matches_cpu=True)
    out["seconds"] = time.perf_counter() - t_phase
    say("entropy", seconds=round(out["seconds"], 1))
    return out


PREDICT_STEP_J18 = 16.0   # phase 11: the J18 frame's one step
PREDICT_GS_STEP = 1.0      # phase 11: the 3DGS merge's one step (the sweep's finest)
PREDICT_REC_TOL = {"float32": 1e-3, "float64": 1e-9}   # encoder rec against the
# host decode of its stream, relative to the channel's range


def rel_err(a, b, ref) -> float:
    """Largest |a - b| over the channel's range of ``ref``, over channels."""
    import numpy as np

    span = np.maximum(np.ptp(np.asarray(ref, np.float64), axis=0), 1e-30)
    return float((np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) / span).max())


def phase_predict(torch, ds, cli, gs, keep):
    """Phase 11: predicted RAHT. The device encoder against the host closed
    loop on phase 3's J10 frame (float32 and float64), a J18 frame (int64
    codes) and phase 7's 3DGS merge (56 channels): every stream decodes by
    the host loop within step / 2, the encoder's own reconstruction and the
    non-normative device decode agree with that decode, the sweep equals
    per-step encode; then ``encode_ply --predict`` and ``decode`` (full and
    progressive) on phase 6's raw cloud and ``encode_3dgs --predict`` on
    phase 7's merge, with the scan launches read around each path, and the
    encoders' and decoders' times."""
    import contextlib
    import csv
    import io
    import os

    import numpy as np

    from raht3dgs_tpu_torch.cli import decode, encode_3dgs, encode_ply
    from raht3dgs_tpu_torch.codec.bitstream import FrameStream
    from raht3dgs_tpu_torch.config import ColorCodecConfig, GsCodecConfig
    from raht3dgs_tpu_torch.io.ply import read_compressed_3dgs_ply, read_ply_8i
    from raht3dgs_tpu_torch.models import pipeline as tp
    from raht3dgs_tpu_torch.ops import praht as hp
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv
    from raht3dgs_tpu_torch.ops.praht_device import praht_device_decode
    from raht3dgs_tpu_torch.ops.voxelize import voxelize
    from raht3dgs_tpu_torch.utils.synth import synthetic_positions

    t_phase = time.perf_counter()
    out = {}
    paths = ("predict_codec_j10", "predict_cli", "predict_gs_cli")
    launches = {p: {name: 0 for name in ds.LAUNCHES} for p in paths}

    def counted(path, fn, *args):
        """``fn(*args)`` with the scan launches added to ``path``; its wall."""
        torch.cuda.synchronize()
        ds.reset_launches()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        for k, v in ds.LAUNCHES.items():
            if path is not None:
                launches[path][k] += v
        return res, time.perf_counter() - t0

    def symbols(stream):
        q = np.zeros((stream.n_channels, stream.n_voxels), np.int32)
        tp.decode_entropy_channels(stream, stream.n_voxels, q)
        return q

    def frame_checks(name, frame, dtype, steps, full=True, path=None):
        """Device against host encode of one frame at one step (and the
        sweep when ``full``), the first encode and its decode counted into
        ``path``; returns the numbers of the phase's line."""
        n = frame.n_voxels
        key = "float32" if dtype == torch.float32 else "float64"
        want = frame.attributes[:n].cpu().numpy()
        dev = tp.AttributeCodec(frame.depth, dtype=dtype, predict=True)
        check(dev._predict_on_device(), f"{name}: predict_impl auto is not the device")
        host = tp.AttributeCodec(frame.depth, dtype=dtype, predict=True, predict_impl="host")
        step = steps[0]
        row = {"n": n, "dtype": key, "step": step}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the first encode builds the frame's device context (the forward
        # transform and the plan); the decode is the host loop
        enc_d, row["device_first_encode_s"] = counted(path, dev.encode, frame, step)
        row["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        st_d = FrameStream.from_bytes(enc_d.stream.to_bytes())
        (rec_d, _), row["host_decode_first_s"] = counted(path, dev.decode, st_d, frame.codes,
                                                         frame.weights)
        t0 = time.perf_counter()
        st_h = host.encode(frame, step).stream
        row["host_first_encode_s"] = time.perf_counter() - t0
        rec_h, _ = host.decode(st_h, frame.codes, frame.weights)
        for tag, rec in (("device", rec_d), ("host", rec_h)):
            check(rec.shape == want.shape and np.isfinite(rec).all(), f"{name}: {tag} decode")
            rmse = np.sqrt(np.mean((rec.astype(np.float64) - want) ** 2, axis=0))
            check((rmse <= np.broadcast_to(step, rmse.shape) / 2).all(),
                  f"{name}: {tag} stream RMSE {rmse} above step / 2")
            row[f"rmse_over_step_max_{tag}"] = float((rmse / step).max())
        q_d, q_h = symbols(st_d), symbols(st_h)
        row["symbols_equal_host_share"] = float((q_d == q_h).mean())
        row["mask_device"], row["mask_host"] = st_d.predict_mask, st_h.predict_mask
        row["bytes_device"], row["bytes_host"] = st_d.payload_bytes, st_h.payload_bytes
        q_T, maskbits, rec_enc = dev.praht_device_step(frame, step)
        check(int(maskbits) == st_d.predict_mask, f"{name}: the step's mask differs")
        row["encoder_rec_rel_err"] = rel_err(rec_enc[:n].cpu().numpy(), rec_d, want)
        check(row["encoder_rec_rel_err"] <= PREDICT_REC_TOL[key],
              f"{name}: encoder rec off its stream's host decode by "
              f"{row['encoder_rec_rel_err']}")
        # the non-normative device decode of the same stream
        vals = np.zeros((st_d.n_channels, frame.codes.shape[0]), np.int32)
        tp.decode_entropy_channels(st_d, n, vals)
        inv = tp._inverse_order_device(frame.codes, frame.weights, n, frame.depth, "ragft")
        plan = dev._praht_dev_context(frame)[2]
        sym = torch.from_numpy(vals).to(frame.codes.device).T[inv.long()]
        steps_t = torch.atleast_1d(torch.as_tensor(np.asarray(step, np.float64))).to(dtype)

        def dev_decode():
            return praht_device_decode(plan, frame.codes, frame.weights, sym,
                                       st_d.predict_mask, frame.depth, steps_t,
                                       quant_mode=st_d.quant_mode, rec_delta=st_d.rec_delta,
                                       fdtype=dtype)

        row["device_decode_rel_err"] = rel_err(dev_decode()[:n].cpu().numpy(), rec_d, want)
        check(row["device_decode_rel_err"] <= PREDICT_REC_TOL[key],
              f"{name}: device decode off the host decode by {row['device_decode_rel_err']}")
        # times: CUDA events first (host-bound), the profiler last
        row["device_encode_ms"] = cuda_ms(torch, lambda: dev.praht_device_step(frame, step),
                                          reps=5, warm=1)
        row["device_decode_ms"] = cuda_ms(torch, dev_decode, reps=3, warm=1)
        row["host_decode_native_ms"] = host_ms(
            lambda: host.decode(st_d, frame.codes, frame.weights), reps=3)
        if full:
            row["host_encode_native_ms"] = host_ms(lambda: host.encode(frame, step), reps=3)
            codes_np = frame.codes.cpu().numpy()[:n]
            w_np = frame.weights.cpu().numpy()[:n]
            fdt = np.float32 if key == "float32" else np.float64
            hplan, _ = host._praht_context(codes_np, w_np, fdt)
            row["host_decode_python_ms"] = host_ms(lambda: hp.praht_decode(
                q_d, codes_np, w_np, frame.depth, step, predict_mask=st_d.predict_mask,
                fdtype=fdt, plan=hplan, backend="python"), reps=3)
            # the sweep: every stream is a per-step encode's and decodes
            sweep_t0 = time.perf_counter()
            sweep = dev.encode_sweep(frame, steps)
            row["device_sweep_s"] = time.perf_counter() - sweep_t0
            for s, enc in zip(steps, sweep):
                check(enc.stream.to_bytes() == dev.encode(frame, s).stream.to_bytes(),
                      f"{name}: encode_sweep step {s:g} != encode")
                rec, _ = host.decode(enc.stream, frame.codes, frame.weights)
                check(np.isfinite(rec).all() and rec.shape == want.shape,
                      f"{name}: sweep step {s:g} does not decode")
            row["sweep_steps"] = len(steps)
        ms, per, split = device_ms(torch, lambda: dev.praht_device_step(frame, step), reps=3,
                                   warm=1)
        row["device_encode_kernel_ms"], row["device_encode_launches_per_step"] = ms, per
        row["device_encode_top_kernels_us"] = dict(
            sorted(split.items(), key=lambda kv: -kv[1])[:6])
        say("predict_" + name, **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                                  for k, v in row.items()})
        return row

    # 1-2. the J10 colour frame (phase 3's) at float32 and float64; J18
    csteps = [float(s) for s in ColorCodecConfig.steps]
    steps16 = [STEP] + [s for s in csteps if s != STEP]
    pts, attrs = synthetic_positions(N_VOX, DEPTH, D_ATTR, seed=0)
    for dtype in (torch.float32, torch.float64):
        frame = tp.prepare_voxel_frame(pts, attrs, DEPTH, bucket=BUCKET, dtype=dtype)
        key = "j10_" + ("float32" if dtype == torch.float32 else "float64")
        # the float32 frame is the main path's configuration: its counts,
        # the sweep and the host encoder's and the numpy twin's times
        f32 = dtype == torch.float32
        out[key] = frame_checks(key, frame, dtype, steps16, full=f32,
                                path="predict_codec_j10" if f32 else None)
    check(launches["predict_codec_j10"] == {"ds_cumsum": 1, "ds_cumsum_t": 0,
                                            "ds_cumsum_batched": 0},
          f"predicted codec: scan launches {launches['predict_codec_j10']}")
    pts18, attrs18 = synthetic_positions(N_VOX, 18, D_ATTR, seed=1)
    frame = tp.prepare_voxel_frame(pts18, attrs18, 18, bucket=BUCKET, dtype=torch.float32)
    check(frame.codes.dtype == torch.int64, "the J18 frame's codes are not int64")
    out["j18"] = frame_checks("j18", frame, torch.float32, [PREDICT_STEP_J18], full=False)

    # 3. the 3DGS J10 merge, 56 channels, float32
    comp = os.path.join(keep, "gs_vox.ply")
    V, A, vsize, vmin = read_compressed_3dgs_ply(comp)
    gframe = tp.prepare_voxel_frame(V, A.astype(np.float64), DEPTH, bucket=BUCKET,
                                    dtype=torch.float32, vmin=vmin, width=vsize * (1 << DEPTH))
    check(gframe.n_voxels == GS_NVOX, f"3DGS merge has {gframe.n_voxels} voxels")
    out["gs"] = frame_checks("gs", gframe, torch.float32, [PREDICT_GS_STEP], full=False)

    # 4. the CLIs: encode_ply --predict on phase 6's raw cloud, decode
    raw, pos_ply = os.path.join(keep, "raw.ply"), os.path.join(keep, "pos.ply")
    sdir, csv_path = os.path.join(keep, "predict"), os.path.join(keep, "predict.csv")
    argv = ["--input", raw, "--voxelize", "--depth", str(DEPTH), "--dtype", "float32",
            "--bucket", str(BUCKET), "--save-streams", sdir, "--csv", csv_path,
            "--predict", "--steps", *[f"{s:g}" for s in csteps]]
    with contextlib.redirect_stdout(io.StringIO()):
        _, enc_s = counted("predict_cli", encode_ply.main, argv)
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    psnr = [float(r["psnr"]) for r in rows]
    bpp = [float(r["Rate_bpp"]) for r in rows]
    check(len(rows) == len(csteps) and all(np.isfinite(psnr)), f"encode_ply --predict: {psnr}")
    check(all(a >= b for a, b in zip(psnr, psnr[1:])), f"PSNR falls as step falls: {psnr}")
    V, C, _ = read_ply_8i(raw)
    res = voxelize(torch.as_tensor(np.concatenate([V, C], 1), device=CARD).float(), DEPTH)
    nvox = int(res.nvox)
    yuv = rgb_to_yuv(res.attributes[:nvox], dtype=torch.float32)
    vframe = tp.prepare_voxel_frame(res.positions[:nvox].cpu().numpy().astype(np.int64),
                                    yuv.cpu().numpy(), DEPTH, bucket=BUCKET,
                                    dtype=torch.float32)
    codec = tp.AttributeCodec(DEPTH, dtype=torch.float32, predict=True)
    for s, enc in zip(csteps, codec.encode_sweep(vframe, csteps)):
        with open(os.path.join(sdir, f"frame0001_step{s:g}.r3tc"), "rb") as f:
            blob = f.read()
        check(blob == enc.stream.to_bytes(), f"the CLI's predicted stream at step {s:g} "
              "!= encode_sweep")
        check(FrameStream.from_bytes(blob).predict, f"step {s:g}: stream not flagged predict")
    s16 = os.path.join(sdir, f"frame0001_step{STEP:g}.r3tc")
    dec_argv = ["--stream", s16, "--positions", pos_ply, "--dtype", "float32",
                "--bucket", str(BUCKET)]
    with contextlib.redirect_stdout(io.StringIO()):
        _, dec_s = counted("predict_cli", decode.main,
                           dec_argv + ["--output", os.path.join(keep, "p_full.ply")])
        _, prog_s = counted("predict_cli", decode.main,
                            dec_argv + ["--output", os.path.join(keep, "p_half.ply"),
                                        "--progressive", str(nvox // 2)])
    Vf, Cf, _ = read_ply_8i(os.path.join(keep, "p_full.ply"))
    Vh, Ch, _ = read_ply_8i(os.path.join(keep, "p_half.ply"))
    check(len(Vf) == len(Vh) == nvox and np.array_equal(Vf, Vh), "predicted decode CLI rows")
    check(launches["predict_cli"] == {"ds_cumsum": 1, "ds_cumsum_t": 0,
                                      "ds_cumsum_batched": 0},
          f"predicted colour CLI path: scan launches {launches['predict_cli']}")
    k16 = csteps.index(STEP)
    out["cli"] = {"nvox": nvox, "encode_ply_s": enc_s, "decode_s": dec_s,
                  "decode_progressive_half_s": prog_s, "psnr": psnr, "bpp": bpp,
                  "plain_rlgr_bpp": cli["bpp"], "plain_rlgr_psnr": cli["psnr"],
                  "step16_bytes_ratio_vs_plain": bpp[k16] / cli["bpp"][k16],
                  "launches": launches["predict_cli"]}
    say("predict_cli", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                          for k, v in out["cli"].items()})

    # encode_3dgs --predict on phase 7's merge, decode of the finest stream
    gsteps = [float(s) for s in GsCodecConfig.steps]
    gdir, gcsv = os.path.join(keep, "gs_predict"), os.path.join(keep, "gs_predict.csv")
    with contextlib.redirect_stdout(io.StringIO()):
        _, genc_s = counted("predict_gs_cli", encode_3dgs.main, [
            "--input", comp, "--depth", str(DEPTH), "--dtype", "float32", "--bucket",
            str(BUCKET), "--render", "none", "--save-streams", gdir, "--csv", gcsv,
            "--predict", "--steps", *[f"{s:g}" for s in gsteps]])
    with open(gcsv) as f:
        grows = list(csv.DictReader(f))
    gpsnr = [float(r["PSNR_all"]) for r in grows]
    gbpp = [float(r["Rate_bpp"]) for r in grows]
    check(len(grows) == len(gsteps) and all(np.isfinite(gpsnr)), f"encode_3dgs: {gpsnr}")
    check(all(a > b for a, b in zip(gpsnr, gpsnr[1:])), f"3DGS PSNR not ordered: {gpsnr}")
    gcodec = tp.AttributeCodec(DEPTH, dtype=torch.float32, predict=True)
    for s, enc in zip(gsteps, gcodec.encode_sweep(gframe, gsteps)):
        with open(os.path.join(gdir, f"gs_step{s:g}.r3tc"), "rb") as f:
            blob = f.read()
        check(blob == enc.stream.to_bytes(), f"the 3DGS CLI's predicted stream at step "
              f"{s:g} != encode_sweep")
        check(FrameStream.from_bytes(blob).predict, f"3DGS step {s:g}: not flagged predict")
    with contextlib.redirect_stdout(io.StringIO()):
        _, gdec_s = counted("predict_gs_cli", decode.main, [
            "--stream", os.path.join(gdir, f"gs_step{min(gsteps):g}.r3tc"), "--positions",
            comp, "--color-space", "3dgs", "--dtype", "float32", "--bucket", str(BUCKET),
            "--output", os.path.join(keep, "gs_p.ply")])
    check(launches["predict_gs_cli"] == {"ds_cumsum": 1, "ds_cumsum_t": 0,
                                         "ds_cumsum_batched": 0},
          f"predicted 3DGS CLI path: scan launches {launches['predict_gs_cli']}")
    out["gs_cli"] = {"nvox": gframe.n_voxels, "encode_3dgs_s": genc_s, "decode_s": gdec_s,
                     "psnr_all": gpsnr, "bpp": gbpp, "plain_rlgr_bpp": gs["cli"]["bpp"],
                     "plain_rlgr_psnr_all": gs["cli"]["psnr_all"],
                     "launches": launches["predict_gs_cli"]}
    say("predict_gs_cli", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                             for k, v in out["gs_cli"].items()})
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    say("predict", seconds=round(out["seconds"], 1))
    return out


RATE_REL_TOL = 1e-12      # phase 12: the rate model, card against CPU, relative
RATE_SYNTH_N = 20_000     # phase 12: the frame searched on the card and on the CPU
RATE_FRAMES = 4           # phase 12: phase 8's frames under encode_dataset's rate modes


def phase_rate(torch, ds, cli, gs, data, keep):
    """Phase 12: rate control at full width. The rate model on the card
    against the same call on the CPU, on phase 3's J10 frame at step 16
    ((2^19, 3)) and phase 7's 3DGS merge at step 1 ((2^19, 56)), with the
    64-step grid's time, launches and peak memory; ``search_step_for_bpp``
    on phase 6's raw cloud (plain and predicted) and on a 20 000-voxel
    synthetic frame on the card and the CPU; then ``encode_ply
    --target-bpp`` -> ``decode`` without positions, ``encode_3dgs
    --target-bpp`` -> ``decode --color-space 3dgs`` and ``encode_dataset``
    in four rate modes on phase 8's tree, with the scan launches read
    around each path."""
    import csv
    import os

    import numpy as np

    from raht3dgs_tpu_torch.cli import decode, encode_3dgs, encode_dataset, encode_ply
    from raht3dgs_tpu_torch.codec.bitstream import FrameStream
    from raht3dgs_tpu_torch.config import ColorCodecConfig, GsCodecConfig
    from raht3dgs_tpu_torch.eval.synth import synthetic_color_frame
    from raht3dgs_tpu_torch.io.ply import read_compressed_3dgs_ply, read_ply_8i
    from raht3dgs_tpu_torch.models import pipeline as tp
    from raht3dgs_tpu_torch.models.rate_control import RateController
    from raht3dgs_tpu_torch.models.rd_search import _estimate_bpp_grid, search_step_for_bpp
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv
    from raht3dgs_tpu_torch.ops.quantize import quantize
    from raht3dgs_tpu_torch.ops.rate_model import estimate_rlgr_bits
    from raht3dgs_tpu_torch.ops.voxelize import voxelize
    from raht3dgs_tpu_torch.utils.synth import morton_codes_np, synthetic_positions

    t_phase = time.perf_counter()
    out = {}
    modes = {"independent": [], "cbr": ["--cbr"], "cbr_gop2": ["--cbr", "--cbr-gop", "2"],
             "two_pass": ["--two-pass"]}
    paths = ("rate_cli", "rate_gs_cli", *[f"rate_dataset_{m}" for m in modes])
    launches = {p: {name: 0 for name in ds.LAUNCHES} for p in paths}

    def counted(path, fn, *args):
        return run_counted(torch, ds, launches[path], fn, *args)

    # 1. the rate model, card against CPU, and the 64-step grid on the card
    pts, attrs = synthetic_positions(N_VOX, DEPTH, D_ATTR, seed=0)
    V, A, vsize, vmin = read_compressed_3dgs_ply(os.path.join(keep, "gs_vox.ply"))
    gframe = tp.prepare_voxel_frame(V, A.astype(np.float64), DEPTH, bucket=BUCKET,
                                    dtype=torch.float32, vmin=vmin, width=vsize * (1 << DEPTH))
    grid = np.geomspace(0.25, 4096.0, 64)
    for name, frame, step in (
            ("j10", tp.prepare_voxel_frame(pts, attrs, DEPTH, bucket=BUCKET,
                                           dtype=torch.float32), STEP),
            ("gs", gframe, 1.0)):
        codec = tp.AttributeCodec(DEPTH, dtype=torch.float32)
        coeffs = codec.transform(frame)[0]
        n = frame.n_voxels
        valid = torch.arange(coeffs.shape[0], device=coeffs.device) < n
        q = quantize(coeffs, torch.tensor(step, device=coeffs.device))
        got = estimate_rlgr_bits(q, valid)
        t0 = time.perf_counter()
        want = estimate_rlgr_bits(q.cpu(), valid.cpu())
        cpu_s = time.perf_counter() - t0
        rel = float(((got.cpu() - want).abs() / want.abs()).max())
        check(rel <= RATE_REL_TOL, f"rate model {name}: card off the CPU by {rel}")
        steps_t = torch.as_tensor(grid[:, None], device=coeffs.device).to(coeffs.dtype)
        ests = _estimate_bpp_grid(coeffs, steps_t, valid, n).cpu().numpy()
        check(np.isfinite(ests).all() and (np.diff(ests) <= 0).all(),
              f"rate model {name}: the grid's estimates do not fall with the step")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        grid_ms = cuda_ms(torch, lambda: _estimate_bpp_grid(coeffs, steps_t, valid, n),
                          reps=5, warm=1)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        kms, per, split = device_ms(torch, lambda: _estimate_bpp_grid(coeffs, steps_t, valid, n),
                                    reps=1, warm=0)
        out[f"model_{name}"] = {
            "shape": list(q.shape), "step": step, "rel_err": rel, "bits": got.sum().item(),
            "grid_ms": grid_ms, "grid_kernel_ms": kms, "grid_launches": per,
            "grid_peak_above_frame_gib": peak, "cpu_estimate_s": cpu_s,
            "grid_top_kernels_us": dict(sorted(split.items(), key=lambda kv: -kv[1])[:4])}
        say(f"rate_model_{name}", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                                     for k, v in out[f"model_{name}"].items()})
        del coeffs, q, valid, steps_t

    # 2. search_step_for_bpp on phase 6's raw cloud, plain and predicted
    csteps = [float(s) for s in ColorCodecConfig.steps]
    raw = os.path.join(keep, "raw.ply")
    V, C, _ = read_ply_8i(raw)
    res = voxelize(torch.as_tensor(np.concatenate([V, C], 1), device=CARD).float(), DEPTH)
    nvox = int(res.nvox)
    cols = res.attributes[:nvox]
    rgb_ref = cols.cpu().numpy()
    vpos = res.positions[:nvox].cpu().numpy().astype(np.int64)
    yuv = rgb_to_yuv(cols, dtype=torch.float32).cpu().numpy()
    vframe = tp.prepare_voxel_frame(vpos, yuv, DEPTH, bucket=BUCKET, dtype=torch.float32)
    target = 1.1 * cli["bpp"][csteps.index(STEP)]
    row = {"nvox": nvox, "target_bpp": target}
    for tag, codec in (("plain", tp.AttributeCodec(DEPTH, dtype=torch.float32)),
                       ("predict", tp.AttributeCodec(DEPTH, dtype=torch.float32, predict=True))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = search_step_for_bpp(vframe, target, codec=codec)
        torch.cuda.synchronize()
        row[f"{tag}_wall_s"] = time.perf_counter() - t0
        check(0.4 * target <= r.bpp <= target * 1.001,
              f"search ({tag}): {r.bpp} bpp against a {target} target")
        row.update({f"{tag}_step": r.step, f"{tag}_bpp": r.bpp, f"{tag}_probes": r.probes,
                    f"{tag}_true_encodes": r.true_encodes})
        if tag == "plain":
            check(r.encoded.stream.to_bytes() == codec.encode(vframe, r.step).stream.to_bytes(),
                  "the search's stream differs from encode at its step")
        else:
            check(codec._predict_on_device() and r.encoded.stream.predict,
                  "the predicted search did not run the device encoder")
            rec, _ = codec.decode(FrameStream.from_bytes(r.encoded.stream.to_bytes()),
                                  vframe.codes, vframe.weights)
            want = vframe.attributes[:nvox].cpu().numpy().astype(np.float64)
            rmse = np.sqrt(np.mean((rec.astype(np.float64) - want) ** 2, axis=0))
            check((rmse <= r.step / 2).all(), f"predicted search: RMSE {rmse} above step / 2")
            row["predict_rmse_over_step_max"] = float((rmse / r.step).max())
    # the same search on the card and on the CPU, float64
    Vs, rgb = synthetic_color_frame(n=RATE_SYNTH_N, depth=DEPTH, seed=0)
    found = {}
    for dev in (CARD, "cpu"):
        f = tp.prepare_voxel_frame(Vs.astype(np.int64), rgb, DEPTH, device=dev)
        c = tp.AttributeCodec(DEPTH, device=dev)
        t = 1.1 * c.encode(f, STEP).stream.bpp()
        t0 = time.perf_counter()
        r = search_step_for_bpp(f, t, codec=c)
        found[dev] = (r.step, r.encoded.stream.to_bytes(), r.true_encodes, t)
        row[f"synth_{dev}_wall_s"] = time.perf_counter() - t0
    check(found[CARD] == found["cpu"], "the search differs between the card and the CPU "
          f"(steps {found[CARD][0]} / {found['cpu'][0]}, true encodes {found[CARD][2]} / "
          f"{found['cpu'][2]})")
    row.update({"synth_nvox": RATE_SYNTH_N, "synth_step": found["cpu"][0],
                "synth_true_encodes": found["cpu"][2]})
    out["search"] = row
    say("rate_search", **row)

    # 3. the CLIs: encode_ply --target-bpp, decode without positions
    sdir = os.path.join(keep, "rate_streams")
    argv = ["--input", raw, "--voxelize", "--depth", str(DEPTH), "--dtype", "float32",
            "--bucket", str(BUCKET), "--target-bpp", f"{target:g}", "--save-streams", sdir,
            "--code-geometry", "--csv", os.path.join(keep, "rate_ply.csv")]
    rc, enc_s, _ = counted("rate_cli", encode_ply.main, argv)
    check(rc == 0, "encode_ply --target-bpp failed")
    spath = os.path.join(sdir, f"frame0001_bpp{target:g}.r3tc")
    with open(spath, "rb") as f:
        stream = FrameStream.from_bytes(f.read())
    check(stream.bpp() <= target * 1.001 and stream.geometry is not None,
          f"encode_ply --target-bpp: {stream.bpp()} bpp, geometry {stream.geometry is not None}")
    dec_ply = os.path.join(keep, "rate_rec.ply")
    rc, dec_s, _ = counted("rate_cli", decode.main, [
        "--stream", spath, "--output", dec_ply, "--dtype", "float32", "--bucket", str(BUCKET)])
    check(rc == 0, "decode of the rate-targeted stream failed")
    V2, C2, _ = read_ply_8i(dec_ply)
    order = np.argsort(morton_codes_np(vpos, DEPTH), kind="stable")
    check(np.array_equal(V2, vpos[order].astype(float)), "decoded positions (Morton order)")
    mse = float(np.mean((C2.astype(np.float64) - rgb_ref[order]) ** 2))
    psnr = 10 * np.log10(255.0**2 / mse)
    check(np.isfinite(psnr), f"rate-targeted decode PSNR {psnr}")
    check(launches["rate_cli"] == {"ds_cumsum": 1, "ds_cumsum_t": 2, "ds_cumsum_batched": 0},
          f"rate-targeted colour CLI path: scan launches {launches['rate_cli']}")
    out["cli"] = {"target_bpp": target, "bpp": stream.bpp(), "geometry_bpp":
                  stream.geometry_bpp(), "rgb_psnr": psnr, "encode_ply_s": enc_s,
                  "decode_s": dec_s, "launches": launches["rate_cli"]}
    say("rate_cli", **{k: json.dumps(v) if isinstance(v, dict) else v
                       for k, v in out["cli"].items()})

    # encode_3dgs --target-bpp, decode --color-space 3dgs
    comp = os.path.join(keep, "gs_vox.ply")
    gsteps = [float(s) for s in GsCodecConfig.steps]
    t3 = 1.1 * gs["cli"]["bpp"][len(gsteps) // 2]
    gdir = os.path.join(keep, "rate_gs")
    rc, genc_s, _ = counted("rate_gs_cli", encode_3dgs.main, [
        "--input", comp, "--depth", str(DEPTH), "--dtype", "float32", "--bucket", str(BUCKET),
        "--target-bpp", f"{t3:g}", "--save-streams", gdir,
        "--csv", os.path.join(keep, "rate_gs.csv")])
    check(rc == 0, "encode_3dgs --target-bpp failed")
    gpath = os.path.join(gdir, f"gs_bpp{t3:g}.r3tc")
    with open(gpath, "rb") as f:
        gstream = FrameStream.from_bytes(f.read())
    check(gstream.bpp() <= t3 * 1.001 and gstream.n_channels == 56,
          f"encode_3dgs --target-bpp: {gstream.bpp()} bpp against {t3}")
    rc, gdec_s, _ = counted("rate_gs_cli", decode.main, [
        "--stream", gpath, "--positions", comp, "--color-space", "3dgs", "--dtype", "float32",
        "--bucket", str(BUCKET), "--output", os.path.join(keep, "rate_gs_rec.ply")])
    check(rc == 0, "decode --color-space 3dgs of the rate-targeted stream failed")
    Vg, Ag, _, _ = read_compressed_3dgs_ply(os.path.join(keep, "rate_gs_rec.ply"))
    check(len(Vg) == GS_NVOX and np.isfinite(Ag).all(), "rate-targeted 3DGS decode")
    check(launches["rate_gs_cli"] == {"ds_cumsum": 1, "ds_cumsum_t": 2, "ds_cumsum_batched": 0},
          f"rate-targeted 3DGS CLI path: scan launches {launches['rate_gs_cli']}")
    out["gs_cli"] = {"target_bpp": t3, "bpp": gstream.bpp(), "step": float(gstream.steps[0]),
                     "encode_3dgs_s": genc_s, "decode_s": gdec_s,
                     "launches": launches["rate_gs_cli"]}
    say("rate_gs_cli", **{k: json.dumps(v) if isinstance(v, dict) else v
                          for k, v in out["gs_cli"].items()})

    # encode_dataset on phase 8's first frames in four rate modes
    mid = len(csteps) // 2
    frames = range(1, RATE_FRAMES + 1)
    td = 1.1 * float(np.mean([data["loop_bpp"][fr][mid] for fr in frames]))
    nv = np.array(data["nvox"][:RATE_FRAMES], dtype=np.float64)
    means = {}
    for mode, extra in modes.items():
        csv_path = os.path.join(keep, f"rate_{mode}.csv")
        rc, wall, text = counted(f"rate_dataset_{mode}", encode_dataset.main, [
            "--dataset", "8iVFBv2", "--sequence", "loot", "--data-root", data["root"],
            "--frames", "1", str(RATE_FRAMES), "--dtype", "float32", "--bucket", str(BUCKET),
            "--target-bpp", f"{td:g}", "--csv", csv_path, *extra])
        check(rc == 0, f"encode_dataset --target-bpp ({mode}) failed")
        with open(csv_path) as f:
            rows = list(csv.DictReader(f))
        check([int(r["Frame"]) for r in rows] == list(frames), f"{mode}: CSV frames")
        bpp = [float(r["Rate_bpp"]) for r in rows]
        check(all(np.isfinite(float(r["psnr"])) for r in rows), f"{mode}: PSNR")
        tol = td * 1e-3
        if mode == "two_pass":
            check(len({r["Quantization_Step"] for r in rows}) == 1, f"{mode}: not one step")
            total = float(np.dot(bpp, nv) / nv.sum())
            check(total <= td * 1.001, f"{mode}: sequence {total} bpp against {td}")
        else:
            rcl = RateController(td) if mode != "independent" else None
            for k, b in enumerate(bpp):
                if rcl is not None and mode == "cbr_gop2" and k % 2 == 0:
                    rcl.reset_credit()
                budget = rcl.frame_budget() if rcl is not None else td
                check(b <= budget + tol, f"{mode}: frame {k + 1} spent {b} of {budget}")
                if rcl is not None:
                    rcl.update(b)
            gop = 2 if mode == "cbr_gop2" else len(bpp)
            for g0 in range(0, len(bpp), gop):
                seg = bpp[g0:g0 + gop]
                for k in range(len(seg)):
                    check(np.mean(seg[:k + 1]) <= td * 1.001,
                          f"{mode}: prefix mean {np.mean(seg[:k + 1])} over {td}")
        means[mode] = float(np.mean(bpp))
        # a forward pack and a decode (two one-column scans) a frame
        want = {"ds_cumsum": RATE_FRAMES, "ds_cumsum_t": 2 * RATE_FRAMES, "ds_cumsum_batched": 0}
        check(launches[f"rate_dataset_{mode}"] == want,
              f"rate dataset path ({mode}): scan launches {launches[f'rate_dataset_{mode}']}")
        out[f"dataset_{mode}"] = {"target_bpp": td, "bpp": bpp, "mean_bpp": means[mode],
                                  "steps": [float(r["Quantization_Step"]) for r in rows],
                                  "psnr": [float(r["psnr"]) for r in rows], "wall_s": wall,
                                  "launches": launches[f"rate_dataset_{mode}"]}
        say("rate_dataset", mode=mode, **{k: json.dumps(v) if isinstance(v, (dict, list))
                                          else v for k, v in out[f"dataset_{mode}"].items()})
    check(means["cbr"] >= means["independent"] - 1e-9,
          f"--cbr spent {means['cbr']} bpp, less than independent budgets' "
          f"{means['independent']}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    say("rate", seconds=round(out["seconds"], 1))
    return out


SEQ_STEP = 16.0            # phase 13: the sequences' one quantization step
SEQ_GOP = 4                # phase 13: an I-frame every 4 frames
SEQ_LOD = 6                # phase 13: the --lod level of the I-frame decode
SEQ_LOD_TOL = 1e-4         # phase 13: --lod on the card against the CPU, over the range
SEQ_TARGET_FRAMES = 4      # phase 13: frames of --target-bpp --inter
JOIN_REPS = 5              # phase 13: CUDA-event repeats of each join's timing


def phase_sequence(torch, ds, data, keep):
    """Phase 13: sequences on phase 8's tree (8 frames of ~0.81 M voxels at
    J=10, each shifted one voxel along x). (a) The temporal ops on the card
    against the CPU on frames 1 -> 2, both joins, each timed; (b)
    ``SequenceCodec(adaptive=False, gop=4)`` over the 8 frames in float32,
    its reconstructions against ``decode_sequence`` on the card; (c)
    ``encode_dataset --inter --gop 4 --code-geometry --save-sequence``, then
    ``decode --all-frames`` without positions and ``decode --frame-index 5``
    (a P-frame, replayed); (d) ``--save-sequence`` from the frame loop and
    from ``--batch 4``; (e) ``decode --frame-index 0 --lod 6`` against the
    CPU's ``decode_lod``; (f) ``--target-bpp --inter`` on 4 frames. The
    scan launches are read around each path and held to the counts
    predicted in PERF.md."""
    import csv
    import os

    import numpy as np

    from raht3dgs_tpu_torch.cli import decode, encode_dataset
    from raht3dgs_tpu_torch.codec.bitstream import SequenceReader
    from raht3dgs_tpu_torch.codec.geometry import decode_geometry
    from raht3dgs_tpu_torch.io.datasets import get_pointcloud
    from raht3dgs_tpu_torch.io.ply import read_ply
    from raht3dgs_tpu_torch.models import pipeline as tp
    from raht3dgs_tpu_torch.models.temporal import SequenceCodec, signalled_global_motion
    from raht3dgs_tpu_torch.ops import temporal as tt
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv
    from raht3dgs_tpu_torch.ops.morton import morton_decode

    t_phase = time.perf_counter()
    root = data["root"]
    n = N_FRAMES
    out = {}
    paths = ("seq_codec", "seq_inter_cli", "seq_all_frames", "seq_frame_index", "seq_loop",
             "seq_batch", "seq_lod", "seq_target_inter")
    launches = {p: {name: 0 for name in ds.LAUNCHES} for p in paths}

    def counted(path, fn, *args):
        return run_counted(torch, ds, launches[path], fn, *args)

    def frame_of(i, device):
        V, C, depth = get_pointcloud("8iVFBv2", "loot", i + 1, root)
        yuv = rgb_to_yuv(torch.as_tensor(np.asarray(C), device=device),
                         dtype=torch.float32).cpu().numpy()
        return tp.prepare_voxel_frame(np.floor(V).astype(np.int64), yuv, depth,
                                      bucket=BUCKET, dtype=torch.float32, device=device)

    def cli_argv(*extra):
        return ["--dataset", "8iVFBv2", "--sequence", "loot", "--data-root", root,
                "--dtype", "float32", "--bucket", str(BUCKET), *extra]

    # (a) the temporal ops, card against CPU, frame 2 predicted from frame 1
    cur, prev = frame_of(1, CARD), frame_of(0, CARD)
    cur_c, prev_c = frame_of(1, "cpu"), frame_of(0, "cpu")
    args = (cur.codes, cur.attributes, cur.weights, prev.codes, prev.attributes, prev.weights)
    args_c = (cur_c.codes, cur_c.attributes, cur_c.weights, prev_c.codes,
              prev_c.attributes, prev_c.weights)

    def ops(a, join):
        ct, at, wt, cp, ap, wp = a
        m = tt.estimate_global_motion(ct, wt, cp, wp, DEPTH, join=join)
        r = tt.refine_block_motion(ct, wt, cp, wp, DEPTH, m, join=join)
        mv = tt.search_block_motion(ct, at, wt, cp, ap, wp, DEPTH, m, stride=4, join=join)
        pred, found = tt.predict_from_previous(ct, cp, ap, wp, DEPTH, 27, mv, join=join)
        return m, r, mv, pred, found

    t0 = time.perf_counter()
    want = [x.numpy() for x in ops(args_c, "search")]
    cpu_s = time.perf_counter() - t0
    check(want[0].tolist() == [1, 0, 0], f"global motion on the CPU {want[0].tolist()}")
    joins = {}
    for join in tt.JOINS:
        got = [x.cpu().numpy() for x in ops(args, join)]
        for name, g, w in zip(("motion", "refine", "search", "pred", "found"), got, want):
            check(g.dtype == w.dtype and np.array_equal(g, w),
                  f"{join} join: {name} on the card differs from the CPU")
        pm = args[3], args[4], args[5]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        joins[join] = {
            "predict_ms": cuda_ms(torch, lambda: tt.predict_from_previous(
                cur.codes, *pm, DEPTH, 27, torch.as_tensor(got[2], device=CARD),
                join=join), reps=JOIN_REPS, warm=1),
            "search_ms": cuda_ms(torch, lambda: tt.search_block_motion(
                *args, DEPTH, torch.as_tensor(got[0], device=CARD), stride=4, join=join),
                reps=JOIN_REPS, warm=1),
            "peak_mem_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
        }
    faster = min(tt.JOINS, key=lambda j: joins[j]["predict_ms"] + joins[j]["search_ms"])
    out["ops"] = {"nvox": [cur.n_voxels, prev.n_voxels], "motion": want[0].tolist(),
                  "found_share": float(want[4][:cur.n_voxels].mean()), "cpu_s": cpu_s,
                  "joins": joins, "faster_join": faster,
                  "default_join": tt.DEFAULT_JOIN}
    say("sequence_ops", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                           for k, v in out["ops"].items()})
    del cur_c, prev_c, args_c, want

    # (b) the sequence codec on the card, its closed loop against its decode
    frames = [frame_of(i, CARD) for i in range(n)]
    sc = SequenceCodec(DEPTH, gop=SEQ_GOP, adaptive=False, dtype=torch.float32,
                       device=CARD)
    timers = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (streams, recs), enc_s, _ = counted("seq_codec", sc.encode_sequence, frames, SEQ_STEP,
                                        timers)
    dec, dec_s, _ = counted("seq_codec", SequenceCodec(DEPTH, dtype=torch.float32, device=CARD)
                            .decode_sequence, streams, frames)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check([s.inter for s in streams] == [i % SEQ_GOP != 0 for i in range(n)],
          "sequence codec: I/P pattern")
    for i, (a, b) in enumerate(zip(recs, dec)):
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"frame {i}: the encoder's reconstruction differs from decode_sequence")
    check(launches["seq_codec"] == {"ds_cumsum": n, "ds_cumsum_t": 4 * n,
                                    "ds_cumsum_batched": 0},
          f"sequence codec: scan launches {launches['seq_codec']}")
    p_bytes, i_bytes, gmv = [], [], []
    for i, (f, s) in enumerate(zip(frames, streams)):
        if s.inter:
            p_bytes.append(s.payload_bytes)
            i_bytes.append(sc.codec.encode(f, SEQ_STEP).stream.payload_bytes)
            gmv.append(signalled_global_motion(s).tolist())
    check(all(g == [1, 0, 0] for g in gmv), f"signalled global motion {gmv}")
    rmse = [float(np.sqrt(np.mean((r - f.attributes[:f.n_voxels].cpu().numpy()) ** 2)))
            for r, f in zip(recs, frames)]
    check(max(rmse) < SEQ_STEP, f"sequence RMSE {rmse}")
    out["codec"] = {"encode_s": enc_s, "decode_s": dec_s, "peak_mem_gib": peak,
                    "p_bytes": p_bytes, "intra_bytes_same_step": i_bytes,
                    "p_over_intra": float(sum(p_bytes) / sum(i_bytes)),
                    "global_motion": gmv, "rmse": rmse,
                    "predict_s": [t.stages.get("Predict_time", 0.0) for t in timers],
                    "launches": launches["seq_codec"]}
    say("sequence_codec", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                             for k, v in out["codec"].items()})
    del frames, recs, dec, sc

    # (c) encode_dataset --inter --code-geometry --save-sequence, then decode
    seq = os.path.join(keep, "inter.r3ts")
    rc, inter_s, text = counted("seq_inter_cli", encode_dataset.main, cli_argv(
        "--frames", "1", str(n), "--steps", f"{SEQ_STEP:g}", "--inter", "--gop",
        str(SEQ_GOP), "--code-geometry", "--save-sequence", seq,
        "--csv", os.path.join(keep, "inter.csv")))
    check(rc == 0, "encode_dataset --inter failed")
    reader = SequenceReader(seq)
    kinds = [reader.frame(i).inter for i in range(len(reader))]
    check(len(kinds) == n and not kinds[0] and not kinds[SEQ_GOP],
          f"--inter: frame kinds {kinds}")
    n_p = sum(kinds)
    check(n_p >= 1, "--inter: no P-frame chosen")
    check(launches["seq_inter_cli"] == {"ds_cumsum": n + n - n // SEQ_GOP,
                                        "ds_cumsum_t": 2 * n, "ds_cumsum_batched": 0},
          f"--inter CLI: scan launches {launches['seq_inter_cli']}")
    with open(os.path.join(keep, "inter.csv")) as f:
        rows = list(csv.DictReader(f))
    all_out = os.path.join(keep, "all_{i}.ply")
    rc, all_s, _ = counted("seq_all_frames", decode.main, [
        "--stream", seq, "--all-frames", "--output", all_out, "--color-space", "raw",
        "--bucket", str(BUCKET)])
    check(rc == 0, "decode --all-frames failed")
    one = os.path.join(keep, "one5.ply")
    rc, one_s, text = counted("seq_frame_index", decode.main, [
        "--stream", seq, "--frame-index", "5", "--output", one, "--color-space", "raw",
        "--bucket", str(BUCKET)])
    check(rc == 0 and "replaying the chain from frame 4" in text,
          "decode --frame-index 5 did not replay from frame 4")
    a5 = np.load(all_out.format(i=5) + ".attrs.npy")
    check(np.array_equal(np.load(one + ".attrs.npy"), a5)
          and open(one, "rb").read() == open(all_out.format(i=5), "rb").read(),
          "decode --frame-index 5 differs from frame 5 of --all-frames")
    check(kinds[5], "frame 5 is not a P-frame")
    v = read_ply(all_out.format(i=5)).vertices
    check(len(v["x"]) == reader.frame(5).n_voxels and np.isfinite(a5).all(),
          "decoded frame 5")
    check(launches["seq_all_frames"] == {"ds_cumsum": 0, "ds_cumsum_t": 2 * n,
                                         "ds_cumsum_batched": 0}
          and launches["seq_frame_index"] == {"ds_cumsum": 0, "ds_cumsum_t": 4,
                                              "ds_cumsum_batched": 0},
          f"decode: scan launches {launches['seq_all_frames']} / "
          f"{launches['seq_frame_index']}")
    sizes = [len(reader.frame_bytes(i)) for i in range(n)]
    nvox = [reader.frame(i).n_voxels for i in range(n)]
    out["inter_cli"] = {
        "encode_s": inter_s, "all_frames_s": all_s, "frame_index_s": one_s,
        "kinds": "".join("P" if k else "I" for k in kinds), "inter_share": n_p / n,
        "frame_bytes": sizes, "bpp": [float(r["Rate_bpp"]) for r in rows],
        "psnr": [float(r["psnr"]) for r in rows],
        "sequence_bits_per_voxel": 8.0 * os.path.getsize(seq) / sum(nvox),
        "geometry_profiles": [reader.frame(i).geometry[0] for i in range(n)]}
    say("sequence_cli", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                           for k, v in out["inter_cli"].items()})

    # (d) --save-sequence from the frame loop and from --batch 4
    blobs = {}
    for mode, extra in (("loop", []), ("batch", ["--batch", str(BATCH)])):
        path = os.path.join(keep, f"{mode}.r3ts")
        rc, wall, _ = counted(f"seq_{mode}", encode_dataset.main, cli_argv(
            "--frames", "1", str(n), "--steps", f"{SEQ_STEP:g}", "--save-sequence", path,
            "--csv", os.path.join(keep, f"{mode}_seq.csv"), *extra))
        check(rc == 0, f"encode_dataset --save-sequence ({mode}) failed")
        blobs[mode] = (open(path, "rb").read(), wall)
    check(blobs["loop"][0] == blobs["batch"][0],
          "--save-sequence: the frame loop and --batch 4 wrote different sequences")
    check(launches["seq_loop"] == {"ds_cumsum": n, "ds_cumsum_t": 2 * n,
                                   "ds_cumsum_batched": 0}
          and launches["seq_batch"] == {"ds_cumsum": 0, "ds_cumsum_t": 0,
                                        "ds_cumsum_batched": 3 * (-(-n // BATCH))},
          f"--save-sequence: scan launches {launches['seq_loop']} / {launches['seq_batch']}")
    out["save_sequence"] = {"bytes": len(blobs["loop"][0]), "loop_s": blobs["loop"][1],
                            "batch_s": blobs["batch"][1]}
    say("sequence_save", **out["save_sequence"])

    # (e) --lod of the I-frame against the CPU's decode_lod
    lod_out = os.path.join(keep, "lod.ply")
    rc, lod_s, text = counted("seq_lod", decode.main, [
        "--stream", seq, "--frame-index", "0", "--lod", str(SEQ_LOD), "--output", lod_out,
        "--color-space", "raw", "--dtype", "float32", "--bucket", str(BUCKET)])
    check(rc == 0, "decode --lod failed")
    s0 = reader.frame(0)
    codes = decode_geometry(s0.geometry, DEPTH, s0.n_voxels)
    V = morton_decode(torch.as_tensor(codes.astype(np.int64)), DEPTH).numpy()
    f0 = tp.prepare_voxel_frame(V, np.zeros((len(V), 3)), DEPTH, bucket=BUCKET,
                                dtype=torch.float32, device="cpu")
    pos, att, cw = tp.AttributeCodec(DEPTH, dtype=torch.float32, device="cpu").decode_lod(
        s0, f0.codes, f0.weights, SEQ_LOD)
    v = read_ply(lod_out).vertices
    got_pos = np.stack([v["x"], v["y"], v["z"]], axis=1)
    got_att = np.load(lod_out + ".attrs.npy")
    span = float(np.ptp(att))
    lod_err = float(np.abs(got_att - att).max()) / span
    check(np.array_equal(got_pos, pos.astype(np.float32))
          and np.array_equal(np.load(lod_out + ".cellw.npy"), cw) and lod_err <= SEQ_LOD_TOL,
          f"--lod {SEQ_LOD}: the card differs from the CPU (err {lod_err})")
    check(launches["seq_lod"] == {"ds_cumsum": 0, "ds_cumsum_t": 2, "ds_cumsum_batched": 0},
          f"--lod: scan launches {launches['seq_lod']}")
    out["lod"] = {"cells": len(pos), "nvox": s0.n_voxels, "rel_err": lod_err, "wall_s": lod_s}
    say("sequence_lod", **out["lod"])

    # (f) --target-bpp --inter on the first frames, a budget of 1.1x the
    # first P-frame's rate at SEQ_STEP
    m = SEQ_TARGET_FRAMES
    target = 1.1 * out["inter_cli"]["bpp"][1]
    csv_t = os.path.join(keep, "target_inter.csv")
    rc, tgt_s, text = counted("seq_target_inter", encode_dataset.main, cli_argv(
        "--frames", "1", str(m), "--inter", "--target-bpp", f"{target:g}", "--csv", csv_t))
    check(rc == 0, "encode_dataset --target-bpp --inter failed")
    with open(csv_t) as f:
        rows = list(csv.DictReader(f))
    bpp = [float(r["Rate_bpp"]) for r in rows]
    check(len(rows) == m and all(b <= target * 1.001 for b in bpp)
          and all(np.isfinite(float(r["psnr"])) for r in rows),
          f"--target-bpp --inter: {bpp} against {target}")
    check(launches["seq_target_inter"] == {"ds_cumsum": 2 * m - 1, "ds_cumsum_t": 2 * m,
                                           "ds_cumsum_batched": 0},
          f"--target-bpp --inter: scan launches {launches['seq_target_inter']}")
    # the frame each candidate won ("[I]" or "[P]" in the CLI's frame lines)
    won = "".join(ln.split("[")[1][0] for ln in text.splitlines()
                  if ln.startswith("frame ") and "[" in ln)
    out["target_inter"] = {"target_bpp": target, "bpp": bpp, "wall_s": tgt_s,
                           "steps": [float(r["Quantization_Step"]) for r in rows],
                           "kinds": won}
    say("sequence_target", **{k: json.dumps(v) if isinstance(v, list) else v
                              for k, v in out["target_inter"].items()})
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    say("sequence", seconds=round(out["seconds"], 1), launches=json.dumps(launches))
    return out


TILE_GS_STEP = 1.0         # phase 14: the one step of the tiled and served 3DGS frames (the finest)
TILE_GS_DEPTH = 3          # phase 14 (a): encode_3dgs --tiles 3 (24 bricks of phase 7's merge)
TILE_COLOUR_DEPTH = 2      # phase 14 (b): encode_ply / encode_dataset --tiles 2
TILE_FRAMES = 4            # phase 14 (b): phase 8's frames in the tiled sequence
GS_ROI = ((800, 100, 400), (1000, 300, 600))      # phase 14: a part of the third shell
DATA_ROI = ((400, 600, 400), (560, 900, 560))     # phase 14 (b): a part of frame 2's third shell
SERVE_VIEWS = 4            # phase 14 (c): the serving CLI's defaults
SERVE_SIZE = 512
SERVE_TOL = 1e-4           # served images against the render of the normative decode
SERVE_SEQ_TOL = 2e-4       # serve_sequence against decode_sequence's render (JAX's pin)
SERVE_SEQ_FRAMES = 4       # phase 14 (c): I P P P
SERVE_REPS = 3             # CUDA-event repeats of each serving call (after one warm call)


def read_png(path):
    """(H, W, 3) uint8 pixels of an 8-bit RGB PNG with unfiltered rows, the
    files ``io/png.py`` writes: its own decoder, so the check does not lean
    on the writer."""
    import struct
    import zlib

    import numpy as np

    data = open(path, "rb").read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        check(zlib.crc32(tag + body) & 0xFFFFFFFF
              == struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0], f"{path}: bad CRC")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, bits, colour = hdr[:4]
    check(bits == 8 and colour == 2, f"{path}: not 8-bit RGB")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), f"{path}: a filtered row")
    return rows[:, 1:].reshape(h, w, 3)


def phase_serving(torch, ds, keep):
    """Phase 14: tiled frames and serving. (a) ``encode_3dgs --tiles 3
    --code-geometry`` on phase 7's merge, ``decode --color-space 3dgs`` in
    full (bitwise the per-tile ``AttributeCodec.decode``) and with ``--roi``
    (bitwise the full decode clipped), and the merge tiled at brick depth 2
    in process; (b) ``encode_ply --voxelize --tiles 2`` on phase 6's raw
    cloud, ``encode_dataset --tiles 2 --save-sequence`` on 4 of phase 8's
    frames, ``decode --all-frames`` and ``decode --frame-index 2 --roi``;
    (c) serving at 4 views of 512x512 on the phase 9 orbit:
    ``serve_tiled_frame`` (culled, then an ROI's bricks), ``serve_frame``,
    ``serve_frame_predicted`` and ``serve_sequence``, each against the
    render of the normative decode, and ``cli.serve --u8`` on the three
    containers; (d) the upload tiers on the served frame's symbols and on a
    P-frame residual. The scan launches are read around each path."""
    import contextlib
    import csv
    import io
    import os

    import numpy as np

    from raht3dgs_tpu_torch.cli import decode, encode_3dgs, encode_dataset, encode_ply, serve
    from raht3dgs_tpu_torch.codec.bitstream import FrameStream, SequenceReader, write_sequence
    from raht3dgs_tpu_torch.codec.geometry import geometry_from_positions
    from raht3dgs_tpu_torch.eval import rasterize
    from raht3dgs_tpu_torch.io.ply import read_compressed_3dgs_ply, read_ply_8i
    from raht3dgs_tpu_torch.models import pipeline as tp, serving as sv, tiling as tl
    from raht3dgs_tpu_torch.models.temporal import SequenceCodec
    from raht3dgs_tpu_torch.utils.synth import morton_codes_np

    t_phase = time.perf_counter()
    out = {}
    paths = ("tiled_encode_3dgs", "tiled_decode_3dgs", "tiled_decode_roi", "tiled_bd2",
             "tiled_encode_ply", "tiled_dataset", "tiled_dataset_decode", "serve_tiled",
             "serve_tiled_roi", "serve_frame", "serve_frame_predicted", "serve_sequence",
             "serve_cli_r3tc", "serve_cli_r3tt", "serve_cli_r3ts")
    launches = {p: {name: 0 for name in ds.LAUNCHES} for p in paths}

    def counted(path, fn, *args):
        return run_counted(torch, ds, launches[path], fn, *args)

    def scan_counts(path, cumsum, cumsum_t):
        want = {"ds_cumsum": cumsum, "ds_cumsum_t": cumsum_t, "ds_cumsum_batched": 0}
        check(launches[path] == want, f"{path}: scan launches {launches[path]}, want {want}")

    def in_box(V, box):
        return np.all((V >= np.asarray(box[0])) & (V < np.asarray(box[1])), axis=1)

    def gs_normalized(A):
        """decode --color-space 3dgs's writer convention, in the decode's
        float32 as the writer computes it."""
        A = A.copy()
        q = A[:, :4]
        nq = np.linalg.norm(q, axis=1, keepdims=True)
        A[:, :4] = np.where(nq > 1e-8, q / np.maximum(nq, 1e-8), np.array([[1.0, 0, 0, 0]]))
        A[:, 4:7] = np.abs(A[:, 4:7])
        A[:, 7] = np.clip(A[:, 7], 0.0, 1.0)
        return A.astype(np.float32)

    step = TILE_GS_STEP
    comp = os.path.join(keep, "gs_vox.ply")
    Vg, Ag, vsize, vmin = read_compressed_3dgs_ply(comp)
    check(len(Vg) == GS_NVOX, f"3DGS merge has {len(Vg)} voxels")
    width = vsize * (1 << DEPTH)

    # (a) encode_3dgs --tiles 3 --code-geometry, decode in full and --roi
    tdir = os.path.join(keep, "tiled")
    rc, enc_s, _ = counted("tiled_encode_3dgs", encode_3dgs.main, [
        "--input", comp, "--depth", str(DEPTH), "--dtype", "float32", "--bucket", str(BUCKET),
        "--steps", f"{step:g}", "--tiles", str(TILE_GS_DEPTH), "--code-geometry",
        "--save-streams", tdir, "--csv", os.path.join(keep, "tiled.csv")])
    check(rc == 0, "encode_3dgs --tiles failed")
    r3tt = os.path.join(tdir, f"gs_tiled{TILE_GS_DEPTH}_step{step:g}.r3tt")
    blob = open(r3tt, "rb").read()
    reader = tl.TiledReader(blob)
    n_tiles = len(reader)
    check(reader.version == tl.TILE_VERSION and reader.n_voxels == GS_NVOX
          and reader.geometry is not None and reader.meta.dtype32,
          "the .r3tt does not read back as a v2 frame with its geometry")
    scan_counts("tiled_encode_3dgs", n_tiles, 2 * n_tiles)   # encode + the CLI's decode
    full_ply = os.path.join(keep, "tiled_full.ply")
    rc, dec_s, _ = counted("tiled_decode_3dgs", decode.main, [
        "--stream", r3tt, "--output", full_ply, "--color-space", "3dgs", "--dtype", "float32",
        "--bucket", str(BUCKET)])
    check(rc == 0, "decode of the .r3tt failed")
    scan_counts("tiled_decode_3dgs", 0, 2 * n_tiles)
    Vf, Af, vs_f, vmin_f = read_compressed_3dgs_ply(full_ply)
    # the per-tile decodes the frame is made of, in process
    codec = tp.AttributeCodec(DEPTH, dtype=torch.float32)
    by_brick = tl.positions_by_brick(Vg, DEPTH, TILE_GS_DEPTH)
    parts_V, parts_A = [], []
    for i in range(n_tiles):
        Vt = by_brick[int(reader.keys[i])]
        frame = tp.prepare_voxel_frame(Vt, np.zeros((len(Vt), 56)), DEPTH, dtype=torch.float32)
        rec, _ = codec.decode(reader.tile(i), frame.codes, frame.weights)
        parts_V.append(Vt)
        parts_A.append(rec)
    Vp, Ap = np.concatenate(parts_V), np.concatenate(parts_A)
    check(np.array_equal(Vf, Vp.astype(Vf.dtype)) and np.array_equal(Af, gs_normalized(Ap))
          and vs_f == vsize and np.allclose(vmin_f, vmin),
          "the tiled decode differs from its per-tile AttributeCodec.decode")
    roi_ply = os.path.join(keep, "tiled_roi.ply")
    rc, roi_s, _ = counted("tiled_decode_roi", decode.main, [
        "--stream", r3tt, "--output", roi_ply, "--color-space", "3dgs", "--dtype", "float32",
        "--bucket", str(BUCKET), "--roi", *[str(c) for c in GS_ROI[0] + GS_ROI[1]]])
    check(rc == 0, "decode --roi of the .r3tt failed")
    roi_sel = reader.select_roi(*GS_ROI)
    Vr, Ar, _, _ = read_compressed_3dgs_ply(roi_ply)
    keep_rows = in_box(Vf, GS_ROI)
    check(0 < len(roi_sel) < n_tiles and len(Vr) > 0 and np.array_equal(Vr, Vf[keep_rows])
          and np.array_equal(Ar, Af[keep_rows]),
          "decode --roi differs from the full decode clipped to the box")
    scan_counts("tiled_decode_roi", 0, 2 * len(roi_sel))
    roi_bytes = reader.fixed_bytes + sum(len(reader.tile_bytes(i)) for i in roi_sel)
    # the same merge at brick depth 2, in process, and the monolithic stream
    mdir = os.path.join(keep, "mono")
    with contextlib.redirect_stdout(io.StringIO()):
        check(encode_3dgs.main(["--input", comp, "--depth", str(DEPTH), "--dtype", "float32",
                                "--bucket", str(BUCKET), "--steps", f"{step:g}",
                                "--code-geometry", "--save-streams", mdir, "--csv",
                                os.path.join(keep, "mono.csv")]) == 0,
              "encode_3dgs (monolithic) failed")
    mono_path = os.path.join(mdir, f"gs_step{step:g}.r3tc")
    mono = FrameStream.from_bytes(open(mono_path, "rb").read())
    (blob2, stats2), enc2_s, _ = counted("tiled_bd2", lambda: tl.encode_tiled_frame(
        Vg, Ag, DEPTH, 2, codec, step, code_geometry=True, vmin=vmin, width=width))
    (V2, A2), dec2_s, _ = counted("tiled_bd2", lambda: tl.decode_tiled_frame(blob2,
                                                                              codec=codec))
    check(np.array_equal(V2, Vf.astype(V2.dtype)) and len(A2) == GS_NVOX
          and np.isfinite(A2).all(), "brick depth 2: decode")
    scan_counts("tiled_bd2", len(stats2), 2 * len(stats2))
    with open(os.path.join(keep, "tiled.csv")) as f:
        trow = list(csv.DictReader(f))[0]
    out["tiled_3dgs"] = {
        "brick_depth": TILE_GS_DEPTH, "tiles": n_tiles, "bytes": len(blob),
        "mono_bytes_same_step": len(mono.to_bytes()), "fixed_bytes": reader.fixed_bytes,
        "over_mono": len(blob) / len(mono.to_bytes()), "encode_cli_s": enc_s,
        "decode_cli_s": dec_s, "psnr_all": float(trow["PSNR_all"]),
        "roi_tiles": len(roi_sel), "roi_voxels": int(keep_rows.sum()),
        "roi_bytes": roi_bytes, "roi_share_of_blob": roi_bytes / len(blob),
        "roi_decode_cli_s": roi_s, "bd2_tiles": len(stats2), "bd2_bytes": len(blob2),
        "bd2_encode_s": enc2_s, "bd2_decode_s": dec2_s}
    say("tiled_3dgs", **out["tiled_3dgs"])
    del parts_V, parts_A, Ap, A2, Ar

    # (b) tiled colour: encode_ply --voxelize --tiles 2, the tiled sequence
    raw = os.path.join(keep, "raw.ply")
    cdir = os.path.join(keep, "tiled_colour")
    rc, cenc_s, _ = counted("tiled_encode_ply", encode_ply.main, [
        "--input", raw, "--voxelize", "--depth", str(DEPTH), "--dtype", "float32",
        "--steps", f"{STEP:g}", "--tiles", str(TILE_COLOUR_DEPTH), "--save-streams", cdir,
        "--code-geometry", "--csv", os.path.join(keep, "tiled_colour.csv")])
    check(rc == 0, "encode_ply --tiles failed")
    creader = tl.TiledReader(open(os.path.join(cdir, f"raw_tiled{TILE_COLOUR_DEPTH}.r3tt"),
                                  "rb").read())
    with open(os.path.join(keep, "tiled_colour.csv")) as f:
        crow = list(csv.DictReader(f))[0]
    check(np.isfinite(float(crow["psnr"])), "encode_ply --tiles: PSNR")
    scan_counts("tiled_encode_ply", len(creader), 2 * len(creader))
    root = os.path.join(keep, "dataset")
    seq = os.path.join(keep, "tiled.r3ts")
    rc, denc_s, _ = counted("tiled_dataset", encode_dataset.main, [
        "--dataset", "8iVFBv2", "--sequence", "loot", "--data-root", root, "--frames", "1",
        str(TILE_FRAMES), "--dtype", "float32", "--steps", f"{STEP:g}", "--tiles",
        str(TILE_COLOUR_DEPTH), "--save-sequence", seq, "--csv",
        os.path.join(keep, "tiled_seq.csv")])
    check(rc == 0, "encode_dataset --tiles failed")
    sreader = SequenceReader(seq)
    frame_tiles = [len(tl.TiledReader(sreader.frame_bytes(i))) for i in range(len(sreader))]
    check(len(sreader) == TILE_FRAMES, f"tiled sequence of {len(sreader)} frames")
    scan_counts("tiled_dataset", sum(frame_tiles), 2 * sum(frame_tiles))
    all_out = os.path.join(keep, "tall_{i}.ply")
    rc, dall_s, _ = counted("tiled_dataset_decode", decode.main, [
        "--stream", seq, "--all-frames", "--output", all_out, "--dtype", "float32"])
    check(rc == 0, "decode --all-frames of the tiled sequence failed")
    one = os.path.join(keep, "troi2.ply")
    rc, droi_s, _ = counted("tiled_dataset_decode", decode.main, [
        "--stream", seq, "--frame-index", "2", "--output", one, "--dtype", "float32", "--roi",
        *[str(c) for c in DATA_ROI[0] + DATA_ROI[1]]])
    check(rc == 0, "decode --frame-index 2 --roi of the tiled sequence failed")
    roi2 = tl.TiledReader(sreader.frame_bytes(2)).select_roi(*DATA_ROI)
    scan_counts("tiled_dataset_decode", 0, 2 * (sum(frame_tiles) + len(roi2)))
    Va, Ca, _ = read_ply_8i(all_out.format(i=2))
    Vo, Co, _ = read_ply_8i(one)
    k2 = in_box(Va, DATA_ROI)
    check(k2.any() and np.array_equal(Vo, Va[k2]) and np.array_equal(Co, Ca[k2]),
          "decode --frame-index 2 --roi differs from frame 2 of --all-frames clipped")
    out["tiled_colour"] = {
        "frame_tiles": len(creader), "frame_bytes": sum(len(creader.tile_bytes(i))
                                                        for i in range(len(creader)))
        + creader.fixed_bytes, "frame_bpp": float(crow["Rate_bpp"]),
        "frame_psnr": float(crow["psnr"]), "encode_ply_s": cenc_s,
        "sequence_tiles": frame_tiles, "sequence_bytes": os.path.getsize(seq),
        "encode_dataset_s": denc_s, "all_frames_s": dall_s, "roi_frame2_s": droi_s,
        "roi_frame2_voxels": int(k2.sum()), "roi_frame2_tiles": len(roi2)}
    say("tiled_colour", **{k: json.dumps(v) if isinstance(v, list) else v
                           for k, v in out["tiled_colour"].items()})

    # (c) serving at 4 views of 512x512 on the phase 9 orbit
    means = (Vg + 0.5) * vsize + vmin
    vms, Kms, _, _ = scene_cameras(np, means, SERVE_VIEWS, SERVE_SIZE)
    raster = dict(width=SERVE_SIZE, height=SERVE_SIZE, device=CARD)

    def render_rows(V, A):
        """The render of a normatively decoded scene (rows in Morton order)."""
        codes = torch.as_tensor(morton_codes_np(np.asarray(V, np.int64), DEPTH), device=CARD)
        scene = sv._scene_from_attrs(torch.as_tensor(A, device=CARD).float(), codes,
                                     torch.ones(len(V), device=CARD), vsize, vmin, DEPTH)
        return sv._render_scene_views(scene, vms, Kms, None, width=SERVE_SIZE,
                                      height=SERVE_SIZE)[0]

    def img_err(a, b):
        return float((a.float() - b.float()).abs().max())

    def timed(fn, n_views=SERVE_VIEWS):
        """ms per call (CUDA events, warm), rasterizer counts and peak
        memory of one call."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rasterize.reset_counts()
        fn()
        torch.cuda.synchronize()
        row = {"raster_counts": dict(rasterize.COUNTS),
               "peak_mem_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
        row["ms"] = cuda_ms(torch, fn, reps=SERVE_REPS, warm=0)
        row["ms_per_view"] = row["ms"] / n_views
        return row

    served = {}
    # serve_tiled_frame on (a)'s blob, culled with margin 0, then the ROI's bricks
    (imgs, dups, tiles, sel), _, _ = counted("serve_tiled", lambda: sv.serve_tiled_frame(
        reader, vms, Kms, **raster))
    scan_counts("serve_tiled", 0, 2 * len(sel))
    Vn, An = tl.decode_tiled_frame(reader, codec=codec)
    brick_of = tl.brick_keys_np(morton_codes_np(Vn.astype(np.int64), DEPTH), DEPTH,
                                TILE_GS_DEPTH)
    rows_sel = np.isin(brick_of, reader.keys[sel])
    ref = render_rows(Vn[rows_sel], An[rows_sel])
    err = img_err(imgs, ref)
    check(err <= SERVE_TOL and float(imgs.std()) > 1e-3,
          f"serve_tiled_frame: {err} from the render of the tiled decode")
    served["tiled"] = {"bricks_served": len(sel), "bricks_total": n_tiles, "max_err": err,
                       "dup_clipped": int(dups.sum()), "tile_clipped": int(tiles.sum()),
                       **timed(lambda: sv.serve_tiled_frame(reader, vms, Kms,
                                                                     **raster))}
    served["tiled"]["device_ms"], _, split = device_ms(
        torch, lambda: sv.serve_tiled_frame(reader, vms, Kms, **raster), reps=1, warm=0)
    served["tiled"]["device_top_kernels_us"] = dict(
        sorted(split.items(), key=lambda kv: -kv[1])[:6])
    (imgs_r, _, _, sel_r), _, _ = counted("serve_tiled_roi", lambda: sv.serve_tiled_frame(
        reader, vms, Kms, **raster, bricks=roi_sel))
    check(sel_r == roi_sel, "serve_tiled_frame(bricks=...) served another selection")
    scan_counts("serve_tiled_roi", 0, 2 * len(roi_sel))
    rows_roi = np.isin(brick_of, reader.keys[roi_sel])
    err_r = img_err(imgs_r, render_rows(Vn[rows_roi], An[rows_roi]))
    check(err_r <= SERVE_TOL, f"serve_tiled_frame(ROI bricks): {err_r}")
    served["tiled_roi"] = {"bricks_served": len(roi_sel), "bricks_total": n_tiles,
                           "max_err": err_r,
                           **timed(lambda: sv.serve_tiled_frame(
                               reader, vms, Kms, **raster, bricks=roi_sel))}
    del Vn, An, ref

    # serve_frame on the monolithic stream: host entropy decode, upload, serve
    gframe = tp.prepare_voxel_frame(Vg, np.zeros((len(Vg), 56)), DEPTH, bucket=BUCKET,
                                    dtype=torch.float32, device=CARD)
    P = gframe.codes.shape[0]
    vals_T = np.zeros((56, P), np.int32)
    t0 = time.perf_counter()
    tp.decode_entropy_channels(mono, mono.n_voxels, vals_T)
    entropy_s = time.perf_counter() - t0
    inv, _, _ = counted("serve_frame", lambda: sv.build_inverse_order(
        gframe.codes, gframe.weights, mono.n_voxels, DEPTH, mono.order_mode))
    up = sv.pack_quantized_upload(vals_T)
    vals_dev = sv.upload_quantized(up, device=CARD)
    fargs = (vals_dev, inv, np.asarray(mono.steps, np.float32), gframe.codes, gframe.weights,
             float(mono.width) / (1 << DEPTH), np.asarray(mono.vmin), vms, Kms)
    fkw = dict(depth=DEPTH, width=SERVE_SIZE, height=SERVE_SIZE, quant_mode=mono.quant_mode,
               rec_delta=mono.rec_delta)
    (imgs, dups, tiles), _, _ = counted("serve_frame", lambda: sv.serve_frame(*fargs, **fkw))
    scan_counts("serve_frame", 0, 2)   # the inverse order's structure pass and the inverse
    rec, _ = codec.decode(mono, gframe.codes, gframe.weights)
    err = img_err(imgs, render_rows(Vf, rec))
    check(err <= SERVE_TOL, f"serve_frame: {err} from the render of AttributeCodec.decode")
    served["frame"] = {"max_err": err, "entropy_decode_s": entropy_s,
                       "dup_clipped": int(dups.sum()), "tile_clipped": int(tiles.sum()),
                       **timed(lambda: sv.serve_frame(*fargs, **fkw))}

    # serve_frame_predicted on phase 11's predicted stream at the same step
    pstream = FrameStream.from_bytes(open(os.path.join(keep, "gs_predict",
                                                       f"gs_step{step:g}.r3tc"), "rb").read())
    check(pstream.predict, "phase 11's stream is not predicted")
    pvals = np.zeros((56, P), np.int32)
    tp.decode_entropy_channels(pstream, pstream.n_voxels, pvals)
    (pinv, plan), _, _ = counted("serve_frame_predicted", lambda: (
        sv.build_inverse_order(gframe.codes, gframe.weights, pstream.n_voxels, DEPTH,
                               pstream.order_mode),
        sv._plan_of(gframe.codes, gframe.weights, DEPTH)))
    pvals_dev = sv.upload_quantized(sv.pack_quantized_upload(pvals), device=CARD)
    pargs = (pvals_dev, pinv, plan, pstream.predict_mask, np.asarray(pstream.steps, np.float32),
             gframe.codes, gframe.weights, float(pstream.width) / (1 << DEPTH),
             np.asarray(pstream.vmin), vms, Kms)
    pkw = dict(depth=DEPTH, width=SERVE_SIZE, height=SERVE_SIZE,
               quant_mode=pstream.quant_mode, rec_delta=pstream.rec_delta)
    (imgs, dups, tiles), _, _ = counted("serve_frame_predicted",
                                        lambda: sv.serve_frame_predicted(*pargs, **pkw))
    scan_counts("serve_frame_predicted", 0, 2)   # the inverse order's and the plan's structure
    pcodec = tp.AttributeCodec(DEPTH, dtype=torch.float32, predict=True)
    t0 = time.perf_counter()
    prec, _ = pcodec.decode(pstream, gframe.codes, gframe.weights)
    host_s = time.perf_counter() - t0
    sym = pvals_dev.to(torch.int32).T[pinv.long()]
    dev_rec = sv.praht_device_decode(
        plan, gframe.codes, gframe.weights, sym, int(pstream.predict_mask), DEPTH,
        torch.as_tensor(np.asarray(pstream.steps, np.float32), device=CARD),
        quant_mode=pstream.quant_mode, rec_delta=pstream.rec_delta,
        fdtype=torch.float32)[:pstream.n_voxels].cpu().numpy()
    over = np.abs(dev_rec - prec) - (1e-4 + 1e-4 * np.abs(prec))
    rec_err = float(np.abs(dev_rec - prec).max())
    check(float(over.max()) <= 0.0,
          f"serve_frame_predicted: the device loop is {rec_err} from the host decode "
          f"(atol = rtol = 1e-4 exceeded by {float(over.max())})")
    err = img_err(imgs, render_rows(Vf, prec))
    check(err <= SERVE_TOL, f"serve_frame_predicted: {err} from the render of the host decode")
    served["frame_predicted"] = {
        "max_err": err, "rec_max_abs_err": rec_err, "host_decode_s": host_s,
        "dup_clipped": int(dups.sum()), "tile_clipped": int(tiles.sum()),
        **timed(lambda: sv.serve_frame_predicted(*pargs, **pkw))}
    del dev_rec, prec, rec

    # serve_sequence: the merge shifted one voxel along x a frame, I P P P
    sx = 1 if int(Vg[:, 0].max()) + SERVE_SEQ_FRAMES <= (1 << DEPTH) else -1
    positions = [Vg + np.array([sx * i, 0, 0]) for i in range(SERVE_SEQ_FRAMES)]
    frames = [tp.prepare_voxel_frame(p, Ag.astype(np.float64), DEPTH, bucket=BUCKET,
                                     dtype=torch.float32, vmin=vmin, width=width,
                                     device=CARD) for p in positions]
    sc = SequenceCodec(DEPTH, gop=SERVE_SEQ_FRAMES, adaptive=False, dtype=torch.float32,
                       device=CARD)
    streams, _ = sc.encode_sequence(frames, step)
    check([s.inter for s in streams] == [False] + [True] * (SERVE_SEQ_FRAMES - 1),
          "serve_sequence: not I P P P")
    for s, p in zip(streams, positions):
        s.geometry = geometry_from_positions(p, DEPTH)
    seq_path = os.path.join(keep, "serve.r3ts")
    write_sequence(seq_path, streams)
    recs = SequenceCodec(DEPTH, dtype=torch.float32, device=CARD).decode_sequence(streams,
                                                                                   frames)

    def play():
        return [r[0] for r in sv.serve_sequence(seq_path, vms, Kms, **raster)]

    imgs_seq, play_s, _ = counted("serve_sequence", play)
    scan_counts("serve_sequence", 0, 2 * SERVE_SEQ_FRAMES)
    errs = [img_err(im, render_rows(p[np.argsort(morton_codes_np(p, DEPTH), kind="stable")],
                                    r)) for im, p, r in zip(imgs_seq, positions, recs)]
    check(max(errs) <= SERVE_SEQ_TOL, f"serve_sequence: {errs} from decode_sequence's render")
    served["sequence"] = {"frames": SERVE_SEQ_FRAMES, "max_err": errs,
                          **timed(play, SERVE_VIEWS * SERVE_SEQ_FRAMES)}
    served["sequence"]["ms_per_frame"] = served["sequence"]["ms"] / SERVE_SEQ_FRAMES

    # (d) the upload tiers on the served frame and on a P-frame residual
    resid = np.zeros((56, frames[1].codes.shape[0]), np.int32)
    tp.decode_entropy_channels(streams[1], streams[1].n_voxels, resid)
    uploads = {}
    for name, m in (("frame", vals_T), ("p_residual", resid)):
        u = sv.pack_quantized_upload(m)
        tier = ("sparse" if u.shape is not None else
                f"{u.vals.dtype.name}{'+patch' if u.patch_idx.size else ''}")
        got = sv.upload_quantized(u, device=CARD)
        check(torch.equal(got.to(torch.int32).cpu(), torch.as_tensor(m)),
              f"upload tier {tier} of the {name} does not widen to its matrix")
        nbytes = u.vals.nbytes + u.patch_idx.nbytes + u.patch_val.nbytes
        uploads[name] = {
            "shape": list(m.shape), "tier": tier, "bytes": nbytes, "int32_bytes": m.nbytes,
            "nonzero_share": float(np.count_nonzero(m)) / m.size,
            "pack_ms": host_ms(lambda: sv.pack_quantized_upload(m)),
            "upload_ms": cuda_ms(torch, lambda: sv.upload_quantized(u, device=CARD), reps=10),
            "int32_upload_ms": cuda_ms(torch, lambda: torch.as_tensor(m).to(CARD), reps=10)}
    out["uploads"] = uploads
    say("serving_upload", **{k: json.dumps(v) for k, v in uploads.items()})
    del frames, recs, streams, resid

    # cli.serve --u8 on the frame, the tiled frame and the sequence
    clis = {}
    for name, path, container in (("r3tc", mono_path, "r3tc"), ("r3tt", r3tt, "r3tt"),
                                  ("r3ts", seq_path, "r3ts")):
        vdir = os.path.join(keep, f"views_{name}")
        rc, wall, text = counted(f"serve_cli_{name}", serve.main, [
            "--stream", path, "--out", vdir, "--u8", "--views", str(SERVE_VIEWS),
            "--size", str(SERVE_SIZE)])
        check(rc == 0, f"cli.serve on the {name} failed")
        rec = json.loads(text.strip().splitlines()[-1])
        frames_n = SERVE_SEQ_FRAMES if name == "r3ts" else 1
        pngs = sorted(os.listdir(vdir))
        check(rec["container"] == container and rec["frames"] == frames_n
              and rec["views"] == SERVE_VIEWS and rec["images"] == len(pngs)
              == frames_n * SERVE_VIEWS and rec["out"] == vdir,
              f"cli.serve on the {name}: {rec}, {len(pngs)} files")
        lit = 0   # views with a pixel off the white background
        for p in pngs:
            px = read_png(os.path.join(vdir, p))
            check(px.shape == (SERVE_SIZE, SERVE_SIZE, 3), f"{p}: {px.shape}")
            lit += int((px < 255).any())
        if name == "r3tt":
            check(rec["bricks_total"] == n_tiles and 0 < rec["bricks_served"] <= n_tiles,
                  f"cli.serve on the r3tt: {rec}")
        clis[name] = {"wall_s": wall, "json_wall_s": rec["wall_s"], "images": rec["images"],
                      "views_not_blank": lit,
                      **({"bricks_served": rec["bricks_served"]} if name == "r3tt" else {})}
    scan_counts("serve_cli_r3tc", 0, 2)
    scan_counts("serve_cli_r3ts", 0, 2 * SERVE_SEQ_FRAMES)
    check(launches["serve_cli_r3tt"]["ds_cumsum_t"] == 2 * clis["r3tt"]["bricks_served"],
          f"serve_cli_r3tt: scan launches {launches['serve_cli_r3tt']}")
    served["cli"] = clis
    for name, row in served.items():
        say(f"serving_{name}", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                                  for k, v in row.items()})
    out["served"] = served
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    say("serving", seconds=round(out["seconds"], 1), launches=json.dumps(launches))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import raht3dgs_tpu_torch  # noqa: F401  (fails outside a checkout)
    from raht3dgs_tpu_torch.ops import ds_scan as ds

    t_start = time.perf_counter()
    card = gpu_line()
    say("device", card=json.dumps(card), torch=torch.__version__,
        cuda=torch.version.cuda, name=json.dumps(torch.cuda.get_device_name(0)))
    libs = build_all()
    say("build", **{k.replace(" ", "_"): round(v.build_seconds, 2)
                    for k, v in libs.items()})
    say("build", ptxas=json.dumps(ptxas_summary(libs["nvcc ds_scan.cu"].build_log)))

    keep = tempfile.mkdtemp(prefix="chip_smoke_")  # phase 6-8 files read by phases 10-12
    try:
        vox, vox_vals = phase_voxelize(torch, ds)  # first: host-bound times before any profiler
        rows = phase_kernels(torch, ds)
        phase_invariants(torch, ds)
        results = phase_main(torch, ds)
        phase_golden(torch)
        cli = phase_cli(torch, ds, keep)
        gs = phase_gs(torch, ds, keep)
        data = phase_dataset(torch, ds, keep)
        render = phase_render(torch, ds)
        entropy = phase_entropy(torch, ds, cli, gs, keep)
        predict = phase_predict(torch, ds, cli, gs, keep)
        rate = phase_rate(torch, ds, cli, gs, data, keep)
        seq = phase_sequence(torch, ds, data, keep)
        serving = phase_serving(torch, ds, keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    add_device_ms(torch, ds, vox["pack"], vox_vals)
    say("voxelize", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                       for k, v in vox["pack"].items()})
    # every path's counts, each read around a run that began from zero
    paths = {"codec_j10": results[DEPTH]["launches"], "cli": cli["launches"],
             "segment_sums_prefix": vox["prefix"]["launches"], "gs_cli": gs["cli"]["launches"],
             "dataset_batch": data["batch"]["launches"], "dataset_loop": data["loop"]["launches"],
             **{f"render_{name}": render[name]["launches"]
                for name in ("voxelize_3dgs", "encode_3dgs", "encode_3dgs_debug")},
             "entropy_cli": entropy["colour"]["launches"],
             "entropy_gs_cli": entropy["gs"]["launches"],
             **predict["launches"], **rate["launches"], **seq["launches"],
             **serving["launches"]}
    rows.append(data["row"])
    for row in rows:
        # `launches`: the codec's main path (phase 3) for the single entry,
        # the batched dataset run for the batched entry
        if row["name"] in SINGLE:
            row["launches"] = results[DEPTH]["launches"][row["name"]]
        row["launches_by_path"] = {p: counts[row["name"]] for p, counts in paths.items()}
        if row["name"] == "ds_cumsum":
            row["voxelize_pack"] = vox["pack"]
            row["gs_pack"] = gs["pack"]
            row["gs_pack_nvox"] = gs["pack_nvox"]
            row["gs_pack_merge"] = gs["pack_merge"]
    say("done", seconds=round(time.perf_counter() - t_start, 1),
        predict_phase_seconds=round(predict["seconds"], 1),
        rate_phase_seconds=round(rate["seconds"], 1),
        sequence_phase_seconds=round(seq["seconds"], 1),
        serving_phase_seconds=round(serving["seconds"], 1))

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
