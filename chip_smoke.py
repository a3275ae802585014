#!/usr/bin/env python3
"""Drive the PyTorch port (``raht3dgs_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line, any failure exits nonzero:

1. device and build: the card, torch/CUDA versions, and the seconds nvcc
   (the scan kernel) and g++ (the RLGR coder) took, built in parallel from
   the checkout's sources;
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
   runs first, so its host-bound times precede every profiler session;
6. the CLIs: that cloud as a binary PLY in a temporary directory through
   ``cli.encode_ply.main`` (``--voxelize``, float32, bucket 2^19, the
   reference's 11-step grid, streams and CSV saved) and one stream through
   ``cli.decode.main``; the CSV, the PSNR order and the decoded colours
   checked, with the kernels' launch counts read around the run. Between
   the two, ``AttributeCodec.encode_sweep`` on the card over the same grid
   must give, step by step, the bytes of one ``encode`` per step and of the
   streams the CLI saved.

Needs one CUDA card; imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import re
import statistics
import subprocess
import sys
import threading
import time

REPLACES = {
    "ds_cumsum": "raht3dgs_tpu/ops/pallas_scan.py:57",    # _scan_kernel
    "ds_cumsum_t": "raht3dgs_tpu/ops/pallas_scan.py:94",  # _scan_kernel_t
}
SOURCE = "raht3dgs_tpu_torch/csrc/ds_scan.cu"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
DS_OPS_PER_ELEM = 11        # adds/subtracts of one ds_add per scanned element

N_RAW = 2_000_000          # phase 5/6 raw points
NVOX_RANGE = (400_000, 520_000)
N_VOX = 500_000
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
    """{kernel<K,pair>: [registers, spill bytes]} from nvcc -Xptxas=-v."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(ds_tile_[a-z]+)ILi(\d+)ELb([01])E", ln)
        if m:
            name = f"{m.group(1)}<{m.group(2)},{m.group(3)}>"
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
    from raht3dgs_tpu_torch.codec.rlgr import NATIVE
    from raht3dgs_tpu_torch.ops.ds_scan import KERNEL

    libs = {"nvcc ds_scan.cu": KERNEL, "g++ rlgr.cpp": NATIVE}
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
            "name": name, "route": "cuda", "source": SOURCE,
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
        for name, cnt in launches.items():
            check(cnt >= 1, f"{name} not launched on the main path")

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


def write_binary_ply(path, pts, rgb=None) -> None:
    """A binary-little-endian PLY: x y z float[, red green blue uchar]."""
    import numpy as np

    names = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if rgb is not None:
        names += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.zeros(len(pts), dtype=names)
    for i, c in enumerate("xyz"):
        rec[c] = pts[:, i]
    head = f"ply\nformat binary_little_endian 1.0\nelement vertex {len(pts)}\n"
    head += "".join(f"property {'float' if t == '<f4' else 'uchar'} {n}\n" for n, t in names)
    if rgb is not None:
        for i, c in enumerate(("red", "green", "blue")):
            rec[c] = rgb[:, i]
    with open(path, "wb") as f:
        f.write((head + "end_header\n").encode())
        rec.tofile(f)


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
        check(launches["ds_cumsum"] == (method == "prefix") and launches["ds_cumsum_t"] == 0,
              f"{method}: scan launches {launches}")
        ms = cuda_ms(torch, lambda: sorted_segment_sums(*on_card, method=method), reps=5, warm=1)
        out[method] = {"ms": ms, "scan_launches": launches["ds_cumsum"],
                       "peak_mem_gib": peak_gib, "sum_err": sum_err, "mean_err": mean_err}
        say("segment_sums", method=method, shape=tuple(on_card[0].shape), **out[method])

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
    return out


def phase_cli(torch, ds):
    """Phase 6: encode_ply --voxelize over the 11-step grid and decode, in
    process, from a binary PLY in a temporary directory."""
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
    from raht3dgs_tpu_torch.utils.synth import morton_codes_np, raw_surface_cloud

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
        for s, enc, one in zip(steps, sweep, per_step):
            blob = enc.stream.to_bytes()
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
    for name, cnt in launches.items():
        check(cnt >= 1, f"{name} not launched on the CLI path")
    out = {"nvox": nvox, "steps": len(steps), "encode_ply_s": enc_s,
           "sweep_mpts": nvox * len(steps) / enc_s / 1e6, "decode_cli_s": dec_s,
           "ply_write_s": write_s,
           "launches": launches, "stage_s": stage_s, "psnr": psnr,
           "bpp": [float(r["Rate_bpp"]) for r in rows]}
    say("cli", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                  for k, v in out.items()})
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

    vox = phase_voxelize(torch, ds)   # first: host-bound times before any profiler
    rows = phase_kernels(torch, ds)
    phase_invariants(torch, ds)
    results = phase_main(torch, ds)
    phase_golden(torch)
    cli = phase_cli(torch, ds)
    for row in rows:
        # `launches`: the codec's main path (phase 3); each path's own count
        # beside it, every one read around a run that began from zero
        row["launches"] = results[DEPTH]["launches"][row["name"]]
        row["launches_by_path"] = {
            "codec_j10": row["launches"], "cli": cli["launches"][row["name"]],
            "segment_sums_prefix": vox["prefix"]["scan_launches"] if row["name"] == "ds_cumsum"
            else 0}
        if row["name"] == "ds_cumsum":
            row["voxelize_pack"] = vox["pack"]
    say("done", seconds=round(time.perf_counter() - t_start, 1))

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
