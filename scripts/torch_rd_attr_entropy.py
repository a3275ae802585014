#!/usr/bin/env python3
"""Measure the RAC entropy profile's real-byte RD gain over RLGR, on the
PyTorch port.

The port's counterpart of ``scripts/rd_attr_entropy.py``: the same
arguments, workloads (``eval/synth.py``: a smooth colour frame, a body
scan, a 3DGS frame of at most 50 000 voxels), arms (``entropy="rlgr"``
against ``entropy="auto"``, the per-channel min of RLGR and RAC) and table
layout, with each workload's BD-rate. Reconstructions are bitwise
identical between the two coders (the quantizer is the same), so the PSNR
column is shared and the BD-rate is a pure rate statement.

    python scripts/torch_rd_attr_entropy.py [--n 100000] [--depth 10] \
        [--device cuda|cpu] [--out F] [--against docs/rd_attr_entropy.md]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_rd_deadzone import (  # noqa: E402
    _psnr_3dgs,
    _psnr_y255,
    add_port_args,
    bd_rate,
    finish_report,
    run_line,
)


def _sweep(frame, steps, psnr_fn, entropy, dev):
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec

    codec = AttributeCodec(frame.depth, entropy=entropy, device=dev)
    coeffs, order, _, _ = codec.transform(frame)
    ref = frame.attributes[: frame.n_voxels].cpu().numpy()
    out = []
    for enc in codec.encode_sweep(frame, steps, coeffs=coeffs, order=order):
        rec, _ = codec.decode(enc.stream, frame.codes, frame.weights)
        out.append((enc.stream.bpp(), psnr_fn(rec, ref),
                    enc.stream.entropy_map))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--color-steps", type=float, nargs="+",
                    default=[1, 2, 4, 6, 8, 12, 16, 20, 24, 32, 64])
    ap.add_argument("--gs-steps", type=float, nargs="+",
                    default=[0.5, 1, 2, 4, 8, 16, 32])
    ap.add_argument("--out", default=None)
    add_port_args(ap)
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    from raht3dgs_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)

    import numpy as np

    from raht3dgs_tpu_torch.eval.synth import (
        synthetic_body_scan,
        synthetic_color_frame,
        synthetic_gs_frame,
    )
    from raht3dgs_tpu_torch.models.pipeline import prepare_voxel_frame
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv

    def color_frame(V, rgb):
        yuv = rgb_to_yuv(np.asarray(rgb), device=dev).cpu().numpy()
        return prepare_voxel_frame(V, yuv, args.depth, device=dev)

    workloads = []
    V, rgb = synthetic_color_frame(args.n, args.depth, args.seed)
    workloads.append(("color (smooth)", color_frame(V, rgb),
                      args.color_steps, _psnr_y255))
    body = synthetic_body_scan(depth=args.depth, seed=args.seed,
                               n_frames=1)[0]
    Vb, rgbb = body[0][: args.n], body[1][: args.n]
    workloads.append(("color (body scan)", color_frame(Vb, rgbb),
                      args.color_steps, _psnr_y255))
    Vg, attrs = synthetic_gs_frame(min(args.n, 50_000), args.depth,
                                   args.seed)
    workloads.append((
        "3DGS 56ch",
        prepare_voxel_frame(Vg, attrs.astype(np.float64), args.depth, device=dev),
        args.gs_steps, _psnr_3dgs,
    ))

    lines = []
    for name, frame, steps, psnr_fn in workloads:
        rl = _sweep(frame, steps, psnr_fn, "rlgr", dev)
        au = _sweep(frame, steps, psnr_fn, "auto", dev)
        assert all(abs(a[1] - b[1]) < 1e-12 for a, b in zip(rl, au))
        bd = bd_rate([r for r, _, _ in rl], [p for _, p, _ in rl],
                     [r for r, _, _ in au], [p for _, p, _ in au])
        lines.append(f"## {name} (n={frame.n_voxels}, J={args.depth}) — "
                     f"BD-rate {bd:+.2f}%")
        lines.append("")
        lines.append("| step | PSNR dB | rlgr bpp | auto bpp | Δrate | "
                     "rac channels |")
        lines.append("|---|---|---|---|---|---|")
        for s, (rb, pp, _), (ab, _, emap) in zip(steps, rl, au):
            nrac = sum(emap) if emap else 0
            lines.append(
                f"| {s:g} | {pp:.2f} | {rb:.4f} | {ab:.4f} | "
                f"{100 * (ab / rb - 1):+.1f}% | {nrac}/{frame.attributes.shape[1]} |"
            )
        lines.append("")
        print("\n".join(lines[-(len(steps) + 5):]))
    report = "\n".join([
        "# RAC entropy profile: real-byte RD vs RLGR `[synthetic]` (PyTorch port)", "",
        "Generated by `scripts/torch_rd_attr_entropy.py`. entropy='auto' = "
        "per-channel min(rlgr, rac) — the deployable mode; PSNR is bitwise "
        "identical between the columns by construction (same quantizer), "
        "so Δrate at each row IS the RD statement.", "",
        run_line("torch_rd_attr_entropy.py", dev, t0), "",
        *lines,
    ])
    return finish_report(args, report)


if __name__ == "__main__":
    sys.exit(main())
