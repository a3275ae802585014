"""Single/multi-PLY colour codec CLI.

Counterpart of ``raht3dgs_tpu/cli/encode_ply.py``: full encode -> decode ->
Y-PSNR/bpp over a quantization-step sweep, logged in the reference's
11-column CSV schema, on CUDA unless ``--platform cpu``. Example:

    python -m raht3dgs_tpu_torch.cli.encode_ply --input frame.ply --depth 18 \\
        --steps 1 2 4 8 16 --csv results/runtime_ply.csv

``--entropy rac|auto`` picks the attribute coder per channel, and
``--code-geometry`` with ``--save-streams`` attaches one lossless geometry
section per frame to every step's stream, so ``cli.decode`` needs no
``--positions``. ``--tiles`` (ROADMAP queue A, item 15), ``--target-bpp``
(item 14) and ``--predict`` (item 13) are not ported yet and exit naming
their item.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import numpy as np
import torch

from raht3dgs_tpu_torch.cli._common import (
    CsvLogger,
    add_geometry_arg,
    add_quant_args,
    add_runtime_args,
    maybe_profile,
    not_ported,
    quant_kwargs,
    torch_dtype,
)
from raht3dgs_tpu_torch.config import ColorCodecConfig
from raht3dgs_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", nargs="+", required=True, help="PLY file(s)")
    p.add_argument(
        "--depth", type=int, default=None,
        help="octree depth J (default: from the PLY 'comment width' header, "
        "else 18 — the reference default)",
    )
    p.add_argument(
        "--steps", type=float, nargs="+", default=list(ColorCodecConfig.steps),
        help="quantization step sweep (reference grid)",
    )
    p.add_argument(
        "--no-decode", action="store_true",
        help="skip the decode half (coefficient-domain PSNR only)",
    )
    p.add_argument(
        "--target-bpp", type=float, default=None,
        help="search the step that hits this rate (not ported yet: ROADMAP "
        "queue A, item 14)",
    )
    p.add_argument(
        "--voxelize", action="store_true",
        help="voxelize raw float positions first (duplicate voxels merge by "
        "attribute mean); without it, inputs must be unique voxel-grid "
        "positions (the reference CLIs' contract)",
    )
    p.add_argument("--save-streams", default=None,
                   help="directory to write .r3tc frame bitstreams")
    p.add_argument(
        "--entropy-chunk", type=int, default=0,
        help="entropy-code each channel in independent chunks of this many "
        "symbols (0 = sequential reference-compatible streams)",
    )
    p.add_argument(
        "--tiles", type=int, default=0, metavar="D",
        help="write a tiled .r3tt stream of octree bricks at depth D (not "
        "ported yet: ROADMAP queue A, item 15)",
    )
    add_geometry_arg(p)
    add_quant_args(p)
    add_runtime_args(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.tiles:
        raise not_ported("--tiles", 15, "the tiled .r3tt stream")
    if args.target_bpp is not None:
        raise not_ported("--target-bpp", 14, "rate control")
    if args.predict:
        raise not_ported("--predict", 13, "predicted RAHT")
    device = resolve_device(args.platform)
    from raht3dgs_tpu_torch.models.color_codec import CSV_HEADER

    log = CsvLogger(args.csv or "results/runtime_ply.csv", CSV_HEADER)
    # context managers: the trace and the CSV finish even when a frame raises
    with maybe_profile(args, device), contextlib.closing(log):
        _sweep(args, log, device)
    return 0


def _sweep(args, log, device) -> None:
    from raht3dgs_tpu_torch.codec.geometry import geometry_from_positions
    from raht3dgs_tpu_torch.io.ply import read_ply_8i
    from raht3dgs_tpu_torch.models.color_codec import DEFAULT_DEPTH, encode_color_frame
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec
    from raht3dgs_tpu_torch.ops.voxelize import voxelize

    dtype = torch_dtype(args.dtype)
    codecs = {}
    for idx, path in enumerate(args.input, start=1):
        V, C, header_depth = read_ply_8i(path)
        depth = args.depth or header_depth or DEFAULT_DEPTH
        if args.voxelize:
            PC = torch.as_tensor(np.concatenate([V, C], axis=1), device=device).to(dtype)
            res = voxelize(PC, depth)
            nvox = int(res.nvox)
            V = res.positions[:nvox].cpu().numpy().astype(float)
            C = res.attributes[:nvox].cpu().numpy()
            print(f"frame {idx}: voxelized to {nvox} voxels")
        if depth not in codecs:
            codecs[depth] = AttributeCodec(depth, dtype=dtype, chunk=args.entropy_chunk,
                                           device=device, **quant_kwargs(args))
        points = encode_color_frame(
            V, C, depth=depth, steps=args.steps, frame_index=idx,
            codec=codecs[depth], bucket=args.bucket, dtype=dtype,
            decode=not args.no_decode, keep_streams=bool(args.save_streams),
        )
        geom = None
        if args.code_geometry and args.save_streams:
            # one geometry section per frame, shared by every step's stream
            geom = geometry_from_positions(V, depth)
            print(f"frame {idx}: geometry {len(geom) * 8.0 / len(V):.3f} "
                  "bits/voxel (lossless)")
        for pt in points:
            log.row(pt.csv_row())
            print(f"frame {idx} step {pt.step:g}: {pt.bpp:.4f} bpp, "
                  f"Y-PSNR {pt.psnr:.2f} dB ({pt.n_voxels} voxels)")
            if args.save_streams and pt.encoded is not None:
                out = Path(args.save_streams)
                out.mkdir(parents=True, exist_ok=True)
                if geom is not None:
                    pt.encoded.stream.geometry = geom
                fn = out / f"frame{idx:04d}_step{pt.step:g}.r3tc"
                fn.write_bytes(pt.encoded.stream.to_bytes())


if __name__ == "__main__":
    sys.exit(main())
