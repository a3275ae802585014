#!/usr/bin/env python3
"""Profile one encode + decode of the PyTorch port's main path on a CUDA card.

    python3 scripts/profile_torch_port.py [--depth 10] [--n 500000] [--seed 0]

Same frame as ``chip_smoke.py`` phase 3 (unique voxels, D=3, bucket 2^19,
float32, step 16). After a warm-up frame, one encode + decode runs under
``torch.profiler``; prints one JSON line with the wall time, the device's
busy share of it (union of CUDA kernel and copy intervals), and the CUDA
time by kernel name, largest first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
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
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = _busy_us(dev_events) / 1e6
    by_name = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
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
