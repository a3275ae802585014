#!/usr/bin/env python3
"""Profile one encode + decode of the PyTorch port's main path on a CUDA card.

    python3 scripts/profile_torch_port.py [--depth 10] [--n 500000] [--seed 0]
    python3 scripts/profile_torch_port.py --scan [--reps 5] [--against ROOT]
    python3 scripts/profile_torch_port.py --gs 2000000 [--depth 10] [--seed 0]
    python3 scripts/profile_torch_port.py --render 2000000 [--size 512] [--seed 0]

Same frame as ``chip_smoke.py`` phase 3 (unique voxels, D=3, bucket 2^19,
float32, step 16). After a warm-up frame, one encode + decode runs under
``torch.profiler``; prints one JSON line with the wall time, the device's
busy share of it (union of CUDA kernel and copy intervals), and the CUDA
time by kernel name, largest first. Needs a CUDA card.

``--scan`` times the double-single scan's entry points alone at the main
path's shapes: ``ds_prefix_pack`` (the forward's pack) and ``ds_cumsum``
at (2^19, 4), ``ds_cumsum_t`` at (1, 2^19); and the wide path's (K > 8):
``ds_prefix_pack`` at (2^19, 57) (the 3DGS transform's pack, the integer
weight lane last) and (2e6, 60) (the Gaussian merge's prefix segment
sums), ``ds_cumsum_t`` at (57, 2^19); and the batched entry at the
dataset path's shapes: ``ds_prefix_pack_batched`` at (4, 2^20, 4) and
``ds_cumsum_batched`` at (4, 2^20, 1); and the sharded entry
``ds_prefix_pack_sharded`` at (2^21, 4) and (2^21, 1) in 4 row shards on
``cuda:0`` (the J=21 frame's pack and weight scans over sp=4), whose
device time counts the copies too (a layout that moves rows between
shards copies them; in both trees alike); then the card's own rates on
those bytes (``card_rates``). For each: the wrapper's time (CUDA
events around one call; 10 x ``--reps`` rounds of 20 calls, each round's
median and their median, taken before any profiler session) and the
device's own time and kernel launches per call (profiler, 50 back-to-back
calls, ``--reps`` rounds), with the device time per call split by kernel
name (mean over the rounds). ``--against ROOT`` loads the
``ops/ds_scan.py`` of another checkout (for example the parent commit,
unpacked with ``git archive``) beside this one, builds both kernels side
by side (their ptxas registers are printed) and times, in turns in one
process, every entry point that both have, so that the host's own drift
between processes does not enter the comparison. Timing helpers are
``chip_smoke.py``'s.

``--gs N`` splits the wall time of the 3DGS sweep CLI: a seeded scene of
N Gaussians (``utils/synth.py:gaussian_scene``) is voxelized and merged
into a compressed PLY in a temporary directory, then ``cli.encode_3dgs``
(float32, bucket 2^19, the reference's 9 steps, streams saved) runs three
times: a warm-up, one under ``cProfile`` (host functions by own and
cumulative time; the profiler's cost per Python call inflates
Python-heavy functions) and one under ``torch.profiler`` (the device's
busy share of the wall and kernel time by name).

``--render N`` splits one view of the render comparison: a seeded scene
of N Gaussians and its merge at ``--depth`` (``compress_to_nvox``), each
on the card, rendered from the comparison's first camera at ``--size``
by ``rasterize_gaussians`` at each tile capacity of ``volumetric_render``'s
retries (1024, 4096, 16384) and at 0, where the blend runs no chunk: CUDA
events, median of 3 after a warm-up, with the chunks, host syncs and
overflow of each; the difference to capacity 0 is the blend's time. Then
one call at 16384 under ``torch.profiler``: the device's busy share of
its wall and kernel time by name.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _busy_us(events) -> float:
    """Length of the union of the device intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _device_events(torch, prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def load_scan_module(root: str):
    """The ``ops/ds_scan.py`` of the checkout at ``root`` as a module of its
    own, its kernel built from that checkout's source into its ``_build/``."""
    import importlib.util

    pkg = os.path.join(os.path.abspath(root), "raht3dgs_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "against_ds_scan", os.path.join(pkg, "ops", "ds_scan.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    os.makedirs(os.path.join(pkg, "_build"), exist_ok=True)
    mod.KERNEL.lib_path = os.path.join(pkg, "_build",
                                       os.path.basename(mod.KERNEL.lib_path))
    return mod


def scan_inputs(torch) -> list:
    """(entry, input) of every ``--scan`` case, made from one seed on the
    card."""
    g = torch.Generator(device="cpu").manual_seed(0)
    n = 1 << 19
    x4 = torch.rand(n, 4, generator=g)
    # the 3DGS transform's pack: sqrt(w)-scaled attributes and the integer
    # weight lane, pads (weight 0) after the real voxels
    w = torch.randint(1, 4, (n,), generator=g).float()
    w[487_180:] = 0.0
    x57 = torch.cat([torch.rand(n, 56, generator=g) * w.sqrt()[:, None], w[:, None]], 1)
    cases = [("ds_prefix_pack", x4), ("ds_cumsum", x4),
             ("ds_cumsum_t", torch.rand(1, n, generator=g)),
             ("ds_prefix_pack", x57),
             ("ds_prefix_pack", torch.rand(2_000_000, 60, generator=g)),
             ("ds_cumsum_t", torch.rand(57, n, generator=g)),
             # the dataset path's batched pack and weight scans (4 frames
             # padded to 2^20 rows)
             ("ds_prefix_pack_batched", torch.rand(4, 2 * n, 4, generator=g)),
             ("ds_cumsum_batched", torch.rand(4, 2 * n, 1, generator=g)),
             # the J=21 frame's (2^21, 4) pack and (2^21, 1) weights over sp=4
             ("ds_prefix_pack_sharded", torch.rand(4 * n, 4, generator=g).split(n)),
             ("ds_prefix_pack_sharded", torch.rand(4 * n, 1, generator=g).split(n))]
    return [(name, [c.contiguous().cuda() for c in x] if isinstance(x, tuple) else x.cuda())
            for name, x in cases]


def _shape(x) -> str:
    """A case's shape: the tensor's, or the whole's over its row shards."""
    if isinstance(x, list):
        return f"{(sum(c.shape[0] for c in x),) + tuple(x[0].shape[1:])} over sp={len(x)}"
    return str(tuple(x.shape))


def scan_times(torch, modules: dict, reps: int) -> dict:
    """Wrapper and device time of the scan's entry points in each module of
    ``modules`` ({label: ds_scan module}) that has them, rounds taken in
    turns (a b, b a, ...), keyed by ``entry (shape)``. Every wrapper time
    comes before any profiler session: the host stays busy for a while
    after a session ends."""
    from chip_smoke import cuda_ms, device_ms

    inputs = {f"{name} {_shape(x)}": (name, x) for name, x in scan_inputs(torch)}
    cases = {label: {key: (getattr(ds, name), x) for key, (name, x) in inputs.items()
                     if hasattr(ds, name)}
             for label, ds in modules.items()}
    out = {label: {key: {"wrapper_ms": [], "device_ms": [], "launches_per_call": [],
                         "by_kernel_us": {}} for key in cases[label]}
           for label in modules}
    labels = list(modules)

    def turns(rounds):
        return [lab for r in range(rounds) for lab in (labels if r % 2 == 0 else labels[::-1])]

    # short wrapper rounds, many of them in turns: the host's slow spells
    # (tens of us a call, lasting seconds) then fall on both sides alike
    for label in turns(10 * reps):
        for key, (fn, x) in cases[label].items():
            out[label][key]["wrapper_ms"].append(
                cuda_ms(torch, lambda: fn(x), reps=20, warm=1))
    for label in turns(reps):
        for key, (fn, x) in cases[label].items():
            ms, launches, split = device_ms(torch, lambda: fn(x),
                                            copies=key.startswith("ds_prefix_pack_sharded"))
            row = out[label][key]
            row["device_ms"].append(ms)
            row["launches_per_call"].append(launches)
            for k, us in split.items():
                row["by_kernel_us"][k] = row["by_kernel_us"].get(k, 0.0) + us / reps
    for row in (r for lab in out.values() for r in lab.values()):
        row["wrapper_ms_median"] = statistics.median(row["wrapper_ms"])
        row["device_ms_median"] = statistics.median(row["device_ms"])
        row["device_ms_range"] = [min(row["device_ms"]), max(row["device_ms"])]
    return out


def card_rates(torch, reps: int) -> dict:
    """What the card reaches on plain PyTorch kernels that move the bytes
    of the sharded (2^21, 4) case: a read of its 33.6 MB input
    (``x.sum()``), a read and a write of it (``torch.mul(x, 1, out=y)``)
    and a write of its 67.1 MB pack (``fill_``); device ms for each of
    ``reps`` rounds (the yardstick of the scan's passes)."""
    from chip_smoke import device_ms

    x = torch.rand(1 << 21, 4, device="cuda")
    y = torch.empty_like(x)
    pack = torch.empty(((1 << 21) + 4) * 8, device="cuda")
    cases = {"read_33.6MB": lambda: x.sum(),
             "read_write_2x33.6MB": lambda: torch.mul(x, 1.0, out=y),
             "write_67.1MB": lambda: pack.fill_(1.0)}
    return {name: [device_ms(torch, fn)[0] for _ in range(reps)]
            for name, fn in cases.items()}


def gs_profile(torch, args) -> dict:
    """``--gs``: where the wall time of ``cli.encode_3dgs`` goes."""
    import cProfile
    import pstats
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from raht3dgs_tpu_torch.cli import encode_3dgs
    from raht3dgs_tpu_torch.models.gs_voxelize import compress_to_nvox
    from raht3dgs_tpu_torch.ops.ds_scan import KERNEL
    from raht3dgs_tpu_torch.utils.synth import gaussian_scene

    KERNEL.load()  # the nvcc build, before any timed run
    with tempfile.TemporaryDirectory() as tmp:
        res = compress_to_nvox(gaussian_scene(args.gs, args.seed), depth=args.depth,
                               output_dir=tmp)
        argv = ["--input", os.path.join(tmp, "compressed_Nvox_gaussians.ply"),
                "--depth", str(args.depth), "--dtype", "float32", "--bucket", str(1 << 19),
                "--csv", os.path.join(tmp, "gs.csv"),
                "--save-streams", os.path.join(tmp, "streams")]

        def run() -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            encode_3dgs.main(argv)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        warm_s = run()
        pr = cProfile.Profile()
        pr.enable()
        cprofile_s = run()
        pr.disable()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch_profile_s = run()
    funcs = [(f"{os.path.basename(fn)}:{ln}:{name}", tt, ct)
             for (fn, ln, name), (_, _, tt, ct, _) in pstats.Stats(pr).stats.items()]
    dev_events = _device_events(torch, prof)
    busy_s = _busy_us(dev_events) / 1e6
    by_name = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {
        "gaussians": args.gs, "voxels": res.n_voxels, "warm_s": warm_s,
        "cprofile_s": cprofile_s, "torch_profile_s": torch_profile_s,
        "device_busy_ms": busy_s * 1e3, "device_busy_share": busy_s / torch_profile_s,
        "top_own_s": [[n, tt] for n, tt, _ in sorted(funcs, key=lambda f: -f[1])[:args.top]],
        "top_cumulative_s": [[n, ct] for n, _, ct in
                             sorted(funcs, key=lambda f: -f[2])[:args.top]],
        "top_kernels_ms": [[n[:90], ms] for n, ms in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]],
    }


def render_profile(torch, args) -> dict:
    """``--render``: where a view of the render comparison goes."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import scene_cameras
    from raht3dgs_tpu_torch.eval import rasterize as tr
    from raht3dgs_tpu_torch.models.gs_voxelize import GS_KEYS, compress_to_nvox, world_positions
    from raht3dgs_tpu_torch.utils.synth import gaussian_scene

    scene = gaussian_scene(args.render, args.seed)
    res = compress_to_nvox(scene, depth=args.depth)
    r = slice(0, res.n_voxels)
    merged = {"means": world_positions(res), "quats": res.quats[r], "scales": res.scales[r],
              "opacities": res.opacities[r], "colors": res.colors[r]}
    vms, Ks, W, H = scene_cameras(np, scene["means"], 1, args.size)
    out = {"size": args.size}
    for name, params in (("original", scene), ("merged", merged)):
        t = [torch.as_tensor(params[k], dtype=torch.float32, device="cuda") for k in GS_KEYS]

        def call(cap):
            return tr.rasterize_gaussians(*t, vms[0], Ks[0], W, H, max_per_tile=cap)

        row = {"n": len(params["means"])}
        for cap in (0, 1024, 4096, 16384):
            call(cap)
            times = []
            for _ in range(3):
                tr.reset_counts()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                _, meta = call(cap)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            row[f"cap_{cap}"] = {"ms": statistics.median(times), "chunks": tr.COUNTS["chunks"],
                                 "syncs": tr.COUNTS["syncs"],
                                 "tile_clipped": int(meta.tile_clipped)}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call(16384)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        dev_events = _device_events(torch, prof)
        by_name = {}
        for e in dev_events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        busy_s = _busy_us(dev_events) / 1e6
        row["profile_16384"] = {
            "wall_ms": wall_s * 1e3, "device_busy_ms": busy_s * 1e3,
            "device_busy_share": busy_s / wall_s, "kernels": len(dev_events),
            "top_kernels_ms": [[n[:90], ms] for n, ms in
                               sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]]}
        out[name] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--scan", action="store_true",
                    help="time the scan kernel's entry points alone")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--gs", type=int, metavar="N",
                    help="split the wall time of the 3DGS sweep CLI on N Gaussians")
    ap.add_argument("--render", type=int, metavar="N",
                    help="split one view of the render comparison on N Gaussians")
    ap.add_argument("--size", type=int, default=512, help="with --render: image size")
    ap.add_argument("--against", metavar="ROOT",
                    help="with --scan: also time the scan of the checkout at "
                         "ROOT, in turns with this one, in the same process")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    if args.scan:
        from raht3dgs_tpu_torch.ops import ds_scan

        from chip_smoke import ptxas_summary

        modules = {"this": ds_scan}
        if args.against:
            modules["against"] = load_scan_module(args.against)
        # both nvcc runs side by side, before anything is timed
        builds = [threading.Thread(target=m.KERNEL.load) for m in modules.values()]
        for t in builds:
            t.start()
        for t in builds:
            t.join()
        for m in modules.values():
            m.KERNEL.load()  # raises here if its build failed
        ptxas = {label: ptxas_summary(m.KERNEL.build_log) for label, m in modules.items()}
        print(json.dumps({"card": card, "ptxas": ptxas,
                          "scan": scan_times(torch, modules, args.reps),
                          "card_rates": card_rates(torch, args.reps)}))
        return 0
    if args.gs:
        print(json.dumps({"card": card, "gs": gs_profile(torch, args)}))
        return 0
    if args.render:
        print(json.dumps({"card": card, "render": render_profile(torch, args)}))
        return 0
    from raht3dgs_tpu_torch.codec.bitstream import FrameStream
    from raht3dgs_tpu_torch.models import pipeline as tp
    from raht3dgs_tpu_torch.utils.synth import synthetic_positions

    pts, attrs = synthetic_positions(args.n, args.depth, 3, seed=args.seed)
    frame = tp.prepare_voxel_frame(pts, attrs, args.depth, bucket=1 << 19,
                                   dtype=torch.float32)
    codec = tp.AttributeCodec(args.depth, dtype=torch.float32)

    def one_frame():
        enc = codec.encode(frame, 16.0)
        rec, timer = codec.decode(FrameStream.from_bytes(enc.stream.to_bytes()),
                                  frame.codes, frame.weights)
        return {**enc.timer.stages, **timer.stages}

    one_frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stages = one_frame()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    dev_events = _device_events(torch, prof)
    busy_s = _busy_us(dev_events) / 1e6
    by_name = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]
    print(json.dumps({
        "card": card, "depth": args.depth, "n": frame.n_voxels,
        "wall_ms": wall_s * 1e3, "device_busy_ms": busy_s * 1e3,
        "device_busy_share": busy_s / wall_s,
        "device_events": len(dev_events),
        "stages_ms": {k: v * 1e3 for k, v in stages.items()},
        "top_kernels_ms": [[name[:90], ms] for name, ms in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
