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
   port's CPU stream hash.

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

    rows = phase_kernels(torch, ds)
    phase_invariants(torch, ds)
    results = phase_main(torch, ds)
    for row in rows:
        row["launches"] = results[DEPTH]["launches"][row["name"]]
    phase_golden(torch)
    say("done", seconds=round(time.perf_counter() - t_start, 1))

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
