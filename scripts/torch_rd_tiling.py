#!/usr/bin/env python3
"""Tiled-frame (ROI / spatial random access) rate overhead and ROI wins,
on the PyTorch port.

The port's counterpart of ``scripts/rd_tiling.py``: the same arguments,
workload (a body-scan frame, ``eval/synth.py``), arms (the monolithic
stream; ``.r3tt`` v1 and v2 at each brick depth; self-contained blobs) and
table layout: rate overhead against the monolithic stream, the tiled
Y-PSNR at the same step, and the bytes a receiver fetches for the central
[side/4, side/2)^3 box.

    python scripts/torch_rd_tiling.py [--n 200000] [--depth 10] \
        [--device cuda|cpu] [--out F] [--against docs/rd_tiling.md]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_rd_deadzone import add_port_args, finish_report, run_line  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--step", type=float, default=16.0)
    ap.add_argument("--bricks", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--entropy", default="rlgr")
    ap.add_argument("--out", default=None)
    add_port_args(ap)
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    from raht3dgs_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)

    import numpy as np

    from raht3dgs_tpu_torch.codec.geometry import geometry_from_positions
    from raht3dgs_tpu_torch.eval.synth import synthetic_body_scan
    from raht3dgs_tpu_torch.models.color_codec import y_psnr_db
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec, prepare_voxel_frame
    from raht3dgs_tpu_torch.models.tiling import (
        TiledReader,
        decode_tiled_frame,
        encode_tiled_frame,
    )
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv
    from raht3dgs_tpu_torch.ops.prelude import morton_codes_np

    V, rgb = synthetic_body_scan(depth=args.depth, seed=args.seed,
                                 n_frames=1)[0]
    if len(V) > args.n:
        V, rgb = V[: args.n], rgb[: args.n]
    yuv = rgb_to_yuv(np.asarray(rgb), device=dev).cpu().numpy()
    codec = AttributeCodec(args.depth, entropy=args.entropy, device=dev)

    frame = prepare_voxel_frame(V, yuv, args.depth, device=dev)
    mono = codec.encode(frame, args.step)
    rec, _ = codec.decode(mono.stream, frame.codes, frame.weights)
    order = np.argsort(morton_codes_np(V.astype(np.int64), args.depth),
                       kind="stable")
    y0 = yuv[order][:, 0]
    mono_bytes = len(mono.stream.to_bytes())
    mono_psnr = y_psnr_db(y0, rec[:, 0])
    n = frame.n_voxels
    print(f"monolithic: {mono_bytes} B ({8 * mono_bytes / n:.4f} bpp), "
          f"Y-PSNR {mono_psnr:.2f} dB, n={n}")

    side = 1 << args.depth
    roi = (np.array([side // 4] * 3), np.array([side // 2] * 3))

    lines = [
        "| brick depth | tiles | v1 bpp | v1 Δ | v2 bpp | v2 Δ | Y-PSNR |"
        " ROI tiles | v2 ROI bytes | vs mono |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for bd in args.bricks:
        blob1, _ = encode_tiled_frame(V, yuv, args.depth, bd, codec, args.step,
                                      bucket=1 << 12, version=1)
        blob, _ = encode_tiled_frame(V, yuv, args.depth, bd, codec, args.step,
                                     bucket=1 << 12)
        reader = TiledReader(blob)
        _, Ad = decode_tiled_frame(blob, positions=V, device=dev)
        psnr = y_psnr_db(y0, Ad[:, 0])
        sel = reader.select_roi(*roi)
        # a v2 ROI fetch pays the fixed header sections + selected bodies
        roi_bytes = reader.fixed_bytes + sum(
            len(reader.tile_bytes(i)) for i in sel)
        line = (f"| {bd} | {len(reader)} | {8 * len(blob1) / n:.4f} | "
                f"{100 * (len(blob1) / mono_bytes - 1):+.1f}% | "
                f"{8 * len(blob) / n:.4f} | "
                f"{100 * (len(blob) / mono_bytes - 1):+.1f}% | "
                f"{psnr:.2f} | {len(sel)}/{len(reader)} | "
                f"{roi_bytes} | {100 * roi_bytes / mono_bytes:.1f}% |")
        lines.append(line)
        print(line)

    # self-contained blobs: per-tile geometry sections (v1) against ONE
    # global section (v2); the attribute payloads are identical, so the
    # delta is pure geometry / container overhead
    geo_global = len(geometry_from_positions(V, args.depth))
    lines += [
        "",
        "Self-contained blobs (`code_geometry=True`; monolithic stream + "
        f"one global geometry section = {mono_bytes + geo_global + 4} B):",
        "",
        "| brick depth | v1 bytes | v2 bytes | geometry overhead v1 | v2 |",
        "|---|---|---|---|---|",
    ]
    for bd in args.bricks:
        g1, _ = encode_tiled_frame(V, yuv, args.depth, bd, codec, args.step,
                                   bucket=1 << 12, code_geometry=True, version=1)
        g2, _ = encode_tiled_frame(V, yuv, args.depth, bd, codec, args.step,
                                   bucket=1 << 12, code_geometry=True)
        base = mono_bytes + geo_global
        line = (f"| {bd} | {len(g1)} | {len(g2)} | "
                f"{100 * (len(g1) / base - 1):+.1f}% | "
                f"{100 * (len(g2) / base - 1):+.1f}% |")
        lines.append(line)
        print(line)

    report = "\n".join([
        "# Tiled frames (.r3tt): rate overhead and ROI economics "
        "`[synthetic]` (PyTorch port)", "",
        f"Body-scan content, n={n}, J={args.depth}, step {args.step:g}, "
        f"entropy={args.entropy} (scripts/torch_rd_tiling.py). Monolithic "
        f"stream: {8 * mono_bytes / n:.4f} bpp at Y-PSNR "
        f"{mono_psnr:.2f} dB. ROI = the frame's central "
        "[side/4, side/2)^3 box. 'ROI bytes' is what a receiver "
        "fetches+decodes for the box with tiles vs EVERYTHING with the "
        "monolithic stream.", "",
        run_line("torch_rd_tiling.py", dev, t0), "",
        *lines,
    ])
    return finish_report(args, report)


if __name__ == "__main__":
    sys.exit(main())
