#!/usr/bin/env python3
"""Drive the PyTorch port (``raht3dgs_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line, any failure exits nonzero:

1. device and build: the card, torch/CUDA versions, and the seconds nvcc
   (the scan kernel) and g++ (the RLGR coder) took, built in parallel from
   the checkout's sources;
2. kernels against their plain PyTorch version on the card, at the main
   path's shapes, with CUDA-event timings;
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
    """Each entry against the plain version on the card."""
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
        # (entry, input, integer lanes, main-path shape)
        ("ds_cumsum", pack, [D_ATTR], True),
        ("ds_cumsum", w.to(dev), [0], False),                  # (2^19, 1)
        ("ds_cumsum_t", pack.T.contiguous(), [D_ATTR], False),  # (4, 2^19)
        ("ds_cumsum_t", w.T.contiguous().to(dev), [0], True),  # (1, 2^19)
        ("ds_cumsum", cancel.to(dev), [], False),
    ]
    rows = []
    for entry, x, int_lanes, main in cases:
        fn = getattr(ds, entry)
        transposed = entry == "ds_cumsum_t"
        xr = x.T if transposed else x                        # (N, K) view
        hi, lo = fn(x)
        torch.cuda.synchronize()
        ph, pl = ds.ds_cumsum_reference(xr.contiguous())
        if transposed:
            hi, lo = hi.T, lo.T
        got = hi.double() + lo.double()
        plain = ph.double() + pl.double()
        ref = torch.cumsum(xr.double(), dim=0)
        scale = max(float(ref.abs().max()), 1.0)
        rel = float((got - ref).abs().max()) / scale
        max_abs = float((got - plain).abs().max())
        if x.shape[0 if not transposed else 1] == 4096:
            check(float((got - ref).abs().max()) < 1e-3, "cancellation case")
        else:
            check(rel < 1e-12, f"{entry}{tuple(x.shape)} rel err {rel}")
        for k in int_lanes:
            check(torch.equal(hi[:, k], ph[:, k]) and not bool(lo[:, k].any()),
                  f"{entry}{tuple(x.shape)} integer lane {k} not exact")
            check(torch.equal(hi[:, k].double(), ref[:, k]),
                  f"{entry}{tuple(x.shape)} integer lane {k} != exact sum")
        say("kernels", entry=entry, shape=tuple(x.shape), rel_err=rel,
            max_abs_err_vs_plain=max_abs)
        if not main:
            continue
        N, K = xr.shape
        ms = cuda_ms(torch, lambda: fn(x))
        plain_ms = cuda_ms(torch, lambda: ds.ds_cumsum_reference(xr), reps=20, warm=1)
        lib_ms = cuda_ms(torch, lambda: torch.cumsum(xr, 0, dtype=torch.float64))
        bytes_ms = 12.0 * N * K / HBM_BYTES_PER_S * 1e3   # read x, write hi, lo
        ops_ms = DS_OPS_PER_ELEM * N * K / F32_OPS_PER_S * 1e3
        rows.append({
            "name": entry, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[entry], "launches": 0, "max_abs_err": max_abs,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_ms,
            "shape": list(x.shape), "kernel_ms": ms,
            "bound_us": max(bytes_ms, ops_ms) * 1e3,
        })
    return rows


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
    ptxas = [ln.strip() for ln in libs["nvcc ds_scan.cu"].build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    say("build", ptxas=json.dumps(ptxas[:6]))

    rows = phase_kernels(torch, ds)
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
