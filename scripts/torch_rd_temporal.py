#!/usr/bin/env python3
"""Measure the inter-frame (I/P) codec's rate gain over all-intra coding,
on the PyTorch port.

The port's counterpart of ``scripts/rd_temporal.py``: the same arguments,
workloads (``eval/synth.synthetic_color_sequence``, a deforming,
translating dense surface, or ``--workload body``), arms (``SequenceCodec``
with GOP 1, all intra, against ``--gop``) and table layout, with the
BD-rate; ``--append`` adds a configuration to the same document.

    python scripts/torch_rd_temporal.py [--depth 9] [--frames 10] \
        [--device cuda|cpu] [--out F] [--append] [--against docs/rd_temporal.md]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_rd_deadzone import (  # noqa: E402
    add_port_args,
    bd_rate,
    finish_report,
    run_line,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--depth", type=int, default=9)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--samples", type=int, default=600_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gop", type=int, default=16)
    ap.add_argument("--steps", type=float, nargs="+",
                    default=[1, 2, 4, 8, 16, 32])
    ap.add_argument("--workload", choices=["shell", "body"],
                    default="shell",
                    help="shell = deforming noisy surface; body = "
                    "articulated humanoid walk (scan-like statistics, "
                    "eval/synth.synthetic_body_scan)")
    ap.add_argument("--phase-rate", type=float, default=0.9,
                    help="body articulation speed in rad of walk phase "
                    "per frame (0.9 = stress-fast; ~0.15 matches 30fps "
                    "capture of normal motion)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--append", action="store_true",
                    help="append to --out instead of overwriting")
    add_port_args(ap)
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    from raht3dgs_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)

    import numpy as np

    from raht3dgs_tpu_torch.eval.synth import synthetic_body_scan, synthetic_color_sequence
    from raht3dgs_tpu_torch.models.pipeline import prepare_voxel_frame
    from raht3dgs_tpu_torch.models.temporal import SequenceCodec

    if args.workload == "body":
        seq = synthetic_body_scan(
            depth=args.depth, n_frames=args.frames, seed=args.seed,
            phase_rate=args.phase_rate,
        )
    else:
        seq = synthetic_color_sequence(
            depth=args.depth, n_frames=args.frames, samples=args.samples,
            seed=args.seed,
        )
    frames = [prepare_voxel_frame(V, C, args.depth, device=dev) for V, C in seq]
    n_total = sum(f.n_voxels for f in frames)
    print(f"{len(frames)} frames, {n_total} voxels total "
          f"(~{n_total // len(frames)} per frame)")

    def run(gop):
        rates, psnrs, inters = [], [], 0
        for step in args.steps:
            sc = SequenceCodec(args.depth, gop=gop, device=dev)
            streams, recons = sc.encode_sequence(frames, steps=step)
            inters = sum(s.inter for s in streams)
            nbytes = sum(s.payload_bytes for s in streams)
            sq = cnt = 0.0
            for f, r in zip(frames, recons):
                ref = f.attributes[: f.n_voxels].cpu().numpy()
                sq += float(np.sum((np.asarray(r) - ref) ** 2))
                cnt += ref.size
            psnr = -10.0 * math.log10(sq / cnt / 255.0**2 + 1e-12)
            rates.append(nbytes * 8.0 / n_total)
            psnrs.append(psnr)
        return rates, psnrs, inters

    intra_r, intra_p, _ = run(gop=1)
    inter_r, inter_p, n_inter = run(gop=args.gop)
    bd = bd_rate(intra_r, intra_p, inter_r, inter_p)

    rows = [
        f"| {s:g} | {ir:.4f} | {ip:.2f} | {er:.4f} | {ep:.2f} "
        f"| {100 * (er - ir) / ir:+.1f}% |"
        for s, ir, ip, er, ep in zip(
            args.steps, intra_r, intra_p, inter_r, inter_p
        )
    ]
    report = "\n".join([
        "# Inter-frame (I/P) coding: measured rate gain (PyTorch port)"
        if not args.append else "## Additional configuration",
        "",
        f"Synthetic dynamic sequence (eval/synth.py, "
        f"workload={args.workload}"
        + (f", phase_rate={args.phase_rate:g}"
           if args.workload == "body" else "") + "): "
        f"{len(frames)} frames, J={args.depth}, "
        f"~{n_total // len(frames)} voxels/frame, GOP={args.gop} "
        f"(P-frames chosen adaptively: {n_inter}/{len(frames)} frames "
        "went inter at the final step). 'intra' = the reference's "
        "per-frame independent coding; PSNR is Y/U/V mean over the "
        "decoder-exact closed-loop reconstructions.",
        "",
        run_line("torch_rd_temporal.py", dev, t0),
        "",
        "| step | intra bpp | intra PSNR | inter bpp | inter PSNR "
        "| Δrate |",
        "|---|---|---|---|---|---|",
        *rows,
        "",
        f"**BD-rate (inter vs intra): {bd:+.2f}%**",
        "",
    ])
    print(report)
    return finish_report(args, report, mode="a" if args.append else "w")


if __name__ == "__main__":
    raise SystemExit(main())
