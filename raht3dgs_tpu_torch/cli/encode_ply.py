"""Single/multi-PLY colour codec CLI.

Counterpart of ``raht3dgs_tpu/cli/encode_ply.py``: full encode -> decode ->
Y-PSNR/bpp over a quantization-step sweep, logged in the reference's
11-column CSV schema, on CUDA unless ``--platform cpu``. Example:

    python -m raht3dgs_tpu_torch.cli.encode_ply --input frame.ply --depth 18 \\
        --steps 1 2 4 8 16 --csv results/runtime_ply.csv

``--entropy rac|auto`` picks the attribute coder per channel, and
``--code-geometry`` with ``--save-streams`` attaches one lossless geometry
section per frame to every step's stream, so ``cli.decode`` needs no
``--positions``. ``--predict`` codes inter-depth predicted RAHT (the device
encoder on the card; ``cli.decode`` reads the stream without a flag).
``--target-bpp T`` replaces the sweep by a search for the step that meets
the rate (``models/rd_search.py``); with ``--save-streams`` it writes
``frameNNNN_bppT.r3tc``. ``--tiles D`` (with ``--save-streams`` and one
``--steps`` value) writes each frame as a tiled ``<name>_tiledD.r3tt`` of
octree bricks at depth D (``models/tiling.py``); ``cli.decode --roi``
decodes the bricks meeting a box.
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
        help="instead of a step sweep, search the quantization step hitting "
        "this rate budget (device-side rate model + refinement)",
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
        help="partition the frame into octree bricks at depth D and write a "
        "tiled .r3tt stream (spatial random access: decode only the bricks "
        "meeting a --roi box, models/tiling.py). Requires --save-streams and "
        "exactly one --steps value; composes with --code-geometry "
        "(self-contained tiles) and --entropy",
    )
    add_geometry_arg(p)
    add_quant_args(p)
    add_runtime_args(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
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
        if args.tiles:
            _encode_tiled(args, idx, path, V, C, depth, codecs[depth], log, device)
            continue
        if args.target_bpp is not None:
            _search(args, idx, V, C, depth, codecs[depth], device)
            continue
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


def _encode_tiled(args, idx: int, path, V, C, depth: int, codec, log, device) -> None:
    """--tiles: one .r3tt tiled frame, and its CSV row with the usual bpp and
    Y-PSNR columns measured through a full tiled decode."""
    import time

    from raht3dgs_tpu_torch.models.color_codec import RDPoint, y_psnr_db
    from raht3dgs_tpu_torch.models.tiling import decode_tiled_frame, encode_tiled_frame
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv
    from raht3dgs_tpu_torch.ops.morton import morton_codes_np

    if not args.save_streams:
        raise SystemExit("--tiles writes a .r3tt stream; pass --save-streams")
    if len(args.steps) != 1:
        raise SystemExit("--tiles requires exactly one --steps value")
    step = args.steps[0]
    t0 = time.perf_counter()
    yuv = rgb_to_yuv(torch.as_tensor(np.asarray(C), device=device),
                     dtype=codec.dtype).cpu().numpy()
    Vi = np.floor(np.asarray(V)).astype(np.int64)
    blob, stats = encode_tiled_frame(Vi, yuv, depth, args.tiles, codec, step,
                                     code_geometry=bool(args.code_geometry))
    enc_s = time.perf_counter() - t0
    out = Path(args.save_streams)
    out.mkdir(parents=True, exist_ok=True)
    dst = out / (Path(path).stem + f"_tiled{args.tiles}.r3tt")
    dst.write_bytes(blob)
    n = len(Vi)
    psnr = float("nan")
    if not args.no_decode:
        _, Ad = decode_tiled_frame(blob, positions=None if args.code_geometry else Vi,
                                   dtype=codec.dtype, device=device)
        order = np.argsort(morton_codes_np(Vi, depth), kind="stable")
        psnr = y_psnr_db(yuv[order][:, 0], Ad[:, 0])
    print(f"frame {idx}: {len(stats)} tiles (brick depth {args.tiles}), {len(blob)} B = "
          f"{8 * len(blob) / n:.4f} bpp, Y-PSNR {psnr:.2f} dB -> {dst}")
    log.row(RDPoint(frame=idx, step=float(step), bpp=8 * len(blob) / n, psnr=psnr,
                    n_voxels=n, stream_bytes=len(blob),
                    times={"Entropy_enc_time": enc_s}).csv_row())


def _search(args, idx: int, V, C, depth: int, codec, device) -> None:
    """--target-bpp: the step that meets the budget for one frame, printed,
    and its stream saved (with the frame's geometry under
    --code-geometry)."""
    from raht3dgs_tpu_torch.codec.geometry import geometry_from_positions
    from raht3dgs_tpu_torch.models.pipeline import prepare_voxel_frame
    from raht3dgs_tpu_torch.models.rd_search import search_step_for_bpp
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv

    yuv = rgb_to_yuv(torch.as_tensor(np.asarray(C), device=device),
                     dtype=codec.dtype).cpu().numpy()
    frame = prepare_voxel_frame(np.floor(np.asarray(V)).astype(np.int64), yuv, depth,
                                bucket=args.bucket, dtype=codec.dtype, device=device)
    res = search_step_for_bpp(frame, args.target_bpp, codec=codec)
    print(f"frame {idx}: target {args.target_bpp:.3f} bpp -> step {res.step:.4f}, "
          f"actual {res.bpp:.3f} bpp ({res.probes} device probes)")
    if args.save_streams:
        out = Path(args.save_streams)
        out.mkdir(parents=True, exist_ok=True)
        s = res.encoded.stream
        if args.code_geometry:
            s.geometry = geometry_from_positions(V, depth)
            print(f"frame {idx}: geometry {s.geometry_bpp():.3f} bits/voxel (lossless)")
        dest = out / f"frame{idx:04d}_bpp{args.target_bpp:g}.r3tc"
        dest.write_bytes(s.to_bytes())
        print(f"frame {idx}: stream -> {dest}")


if __name__ == "__main__":
    sys.exit(main())
