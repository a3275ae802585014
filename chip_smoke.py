#!/usr/bin/env python3
"""Drive the PyTorch port (``raht3dgs_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line, any failure exits nonzero:

1. device and build: the card, torch/CUDA versions, and the seconds nvcc
   (the scan kernel) and g++ (the RLGR, RAC and geometry coders) took,
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
   as binary PLYs in a temporary tree, through ``cli.encode_dataset`` with
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
   scan launches around each CLI run, the same as with RLGR.

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
CARD = "cuda"              # the device phase 9 renders on
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
    from raht3dgs_tpu_torch.ops.ds_scan import KERNEL

    libs = {"nvcc ds_scan.cu": KERNEL, "g++ rlgr.cpp": rlgr.NATIVE,
            "g++ rac.cpp": rac.NATIVE, "g++ geom.cpp": geometry.NATIVE}
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
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
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
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


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


def phase_dataset(torch, ds):
    """Phase 8: the dataset path. Eight seeded 8iVFBv2 frames (about 0.8 M
    voxels each at J=10) as binary PLYs in a temporary tree, through
    ``cli.encode_dataset.main`` with ``--batch 4`` (two batches) and then
    as a frame loop, float32, bucket 2^19, the reference's 11 steps, with
    the scan launches read around each run; the two CSVs against each
    other; in process, one batch's ``encode_sweep`` against per-frame
    ``encode`` and its batched decode against per-frame decode, in float64
    and float32; the scan
    kernel's batched entry at the path's (4, 2^20, 4) pack, on the wide
    path at (2, 2^19, 9) and (3, 2^19, 57), and past the one-block carry,
    then timed."""
    import csv
    import math
    import os
    import tempfile

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
    with tempfile.TemporaryDirectory() as tmp:
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
        "single_entry_ms": single_ms,
    }
    row["device_ms"], row["device_launches_per_call"], row["device_us_by_kernel"] = \
        device_ms(torch, lambda: ds.ds_prefix_pack_batched(body))
    row["single_entry_device_ms"], _, _ = device_ms(
        torch, lambda: [ds.ds_prefix_pack(body[b]) for b in range(B)])
    say("dataset_kernel", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                             for k, v in row.items()})
    out["row"] = row
    out["nvox"] = nvox
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

    keep = tempfile.mkdtemp(prefix="chip_smoke_")  # phase 6-7 files read by phase 10
    try:
        vox, vox_vals = phase_voxelize(torch, ds)  # first: host-bound times before any profiler
        rows = phase_kernels(torch, ds)
        phase_invariants(torch, ds)
        results = phase_main(torch, ds)
        phase_golden(torch)
        cli = phase_cli(torch, ds, keep)
        gs = phase_gs(torch, ds, keep)
        data = phase_dataset(torch, ds)
        render = phase_render(torch, ds)
        entropy = phase_entropy(torch, ds, cli, gs, keep)
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
             "entropy_gs_cli": entropy["gs"]["launches"]}
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
    say("done", seconds=round(time.perf_counter() - t_start, 1))

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
