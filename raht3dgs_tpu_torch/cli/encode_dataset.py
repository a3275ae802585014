"""Dataset RD-sweep CLI (reference: python/encode_dataset.py).

Counterpart of ``raht3dgs_tpu/cli/encode_dataset.py``: loops the colour
codec over the frames of an 8iVFBv2/MVUB sequence, each frame's depth from
its PLY header, logging the reference 11-column CSV; with ``--batch B`` it
encodes B frames per call through the batched codec
(``models/batch_codec.py``). Runs on CUDA unless ``--platform cpu``, on one
device. Example:

    python -m raht3dgs_tpu_torch.cli.encode_dataset --dataset 8iVFBv2 \\
        --sequence redandblack --data-root /data --frames 1 10 --batch 4

``--entropy rac|auto`` picks the attribute coder per channel, in the frame
loop and under ``--batch``. ``--code-geometry`` is accepted, as in the JAX
CLI, where it acts only with ``--save-sequence``, ``--tiles`` or
``--target-bpp``. Those (ROADMAP queue A, item 15: ``--save-sequence``,
``--tiles``; item 14: ``--target-bpp``, ``--cbr``, ``--two-pass``,
``--inter``) and ``--predict`` (item 13) are not ported yet and exit
naming their item, after the JAX CLI's own argument checks.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

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
    p.add_argument("--dataset", required=True, choices=("8iVFBv2", "MVUB"))
    p.add_argument("--sequence", required=True)
    p.add_argument("--data-root", default=".")
    p.add_argument(
        "--frames", type=int, nargs=2, metavar=("FIRST", "LAST"), default=None,
        help="1-based inclusive frame range (default: whole sequence)",
    )
    p.add_argument("--steps", type=float, nargs="+", default=list(ColorCodecConfig.steps))
    p.add_argument("--no-decode", action="store_true")
    p.add_argument(
        "--entropy-chunk", type=int, default=0,
        help="entropy-code each channel in independent chunks "
        "(parallel encode/decode on multi-core hosts; 0 = sequential)",
    )
    p.add_argument(
        "--save-sequence", default=None,
        help="write all frames to one indexed .r3ts sequence file (not "
        "ported yet: ROADMAP queue A, item 15)",
    )
    p.add_argument(
        "--batch", type=int, default=0,
        help="encode this many frames per call through the batched codec "
        "(0 = frame loop); one device",
    )
    p.add_argument(
        "--target-bpp", type=float, default=None,
        help="search each frame's step for this rate (not ported yet: "
        "ROADMAP queue A, item 14)",
    )
    p.add_argument("--cbr", action="store_true",
                   help="with --target-bpp: leaky-bucket allocation (item 14)")
    p.add_argument("--cbr-burst", type=float, default=None,
                   help="with --cbr: bucket depth in bpp (item 14)")
    p.add_argument("--cbr-gop", type=int, default=0,
                   help="with --cbr: reset the carried credit every K frames (item 14)")
    p.add_argument("--two-pass", action="store_true",
                   help="with --target-bpp: one shared step for the sequence (item 14)")
    p.add_argument(
        "--tiles", type=int, default=0, metavar="D",
        help="tiled .r3tt frames inside the .r3ts (not ported yet: ROADMAP "
        "queue A, item 15)",
    )
    p.add_argument("--inter", action="store_true",
                   help="temporal I/P coding (not ported yet: ROADMAP queue A, item 14)")
    p.add_argument("--gop", type=int, default=16,
                   help="with --inter: force an intra frame every GOP frames")
    p.add_argument("--search-stride", type=int, default=None,
                   help="with --inter: motion-search witness sampling stride")
    add_geometry_arg(p)
    add_quant_args(p)
    add_runtime_args(p)
    return p


def _err(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 2


def _refusals(args):
    """The JAX CLI's argument errors (``2``) in its order, with the exits
    of the modes that are not ported yet where it would enter them; None
    when the run may go on."""
    if args.save_sequence and args.target_bpp is None and len(args.steps) != 1:
        return _err("--save-sequence requires exactly one --steps value")
    if (args.cbr or args.cbr_burst is not None or args.cbr_gop) and args.target_bpp is None:
        return _err("--cbr is a rate-control mode; it requires --target-bpp")
    if args.tiles:
        if not args.save_sequence or len(args.steps) != 1:
            return _err("--tiles needs --save-sequence and exactly one --steps value")
        if args.inter or args.batch or args.target_bpp is not None:
            return _err("--tiles is intra-only for now (not with --inter/"
                        "--batch/--target-bpp)")
        raise not_ported("--tiles", 15, "the tiled .r3tt sequence")
    if args.two_pass:
        if args.target_bpp is None:
            return _err("--two-pass is a rate-control mode; it requires --target-bpp")
        if args.cbr or args.cbr_burst is not None or args.inter or args.batch:
            return _err("--two-pass allocates the whole sequence at once; it "
                        "composes with --save-sequence/--code-geometry but not "
                        "with --cbr/--inter/--batch")
        raise not_ported("--two-pass", 14, "rate control")
    if args.target_bpp is not None:
        if args.batch:
            return _err("--target-bpp composes with the frame loop or --inter "
                        "(drop --batch)")
        raise not_ported("--target-bpp", 14, "rate control")
    if args.inter:
        if len(args.steps) != 1:
            return _err("--inter requires exactly one --steps value")
        if args.batch:
            return _err("--inter is sequential by nature; drop --batch")
        raise not_ported("--inter", 14, "temporal I/P coding")
    if args.save_sequence:
        raise not_ported("--save-sequence", 15, "the R3TS sequence container")
    if args.predict:
        raise not_ported("--predict", 13, "predicted RAHT")
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from raht3dgs_tpu_torch.io.datasets import get_pointcloud_n_frames

    n_frames = get_pointcloud_n_frames(args.dataset, args.sequence)
    if n_frames is None:
        return 1
    rc = _refusals(args)
    if rc is not None:
        return rc
    device = resolve_device(args.platform)
    first, last = args.frames or (1, n_frames)
    from raht3dgs_tpu_torch.models.color_codec import CSV_HEADER

    log = CsvLogger(args.csv or "results/runtime_dataset.csv", CSV_HEADER)
    # context managers: the trace and the CSV finish even when a frame raises
    with maybe_profile(args, device), contextlib.closing(log):
        if args.batch > 0:
            _run_batched(args, first, last, log, device)
        else:
            _run_frames(args, first, last, log, device)
    return 0


def _run_frames(args, first: int, last: int, log, device) -> None:
    """The frame loop: one ``encode_color_frame`` sweep per loaded frame."""
    from raht3dgs_tpu_torch.io.datasets import get_pointcloud
    from raht3dgs_tpu_torch.models.color_codec import encode_color_frame
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec

    dtype = torch_dtype(args.dtype)
    codecs = {}
    for frame in range(first, last + 1):
        out = get_pointcloud(args.dataset, args.sequence, frame, args.data_root)
        if out is None:
            print(f"frame {frame}: load failed, skipping", file=sys.stderr)
            continue
        V, C, depth = out
        if depth not in codecs:
            codecs[depth] = AttributeCodec(depth, dtype=dtype, chunk=args.entropy_chunk,
                                           device=device, **quant_kwargs(args))
        for pt in encode_color_frame(
            V, C, depth=depth, steps=args.steps, frame_index=frame,
            codec=codecs[depth], bucket=args.bucket, dtype=dtype,
            decode=not args.no_decode,
        ):
            log.row(pt.csv_row())
        print(f"frame {frame} done")


def _run_batched(args, first: int, last: int, log, device) -> None:
    """Batched path: ``--batch`` frames per call on one device, each chunk
    split into equal-depth batches (a frame's depth is its PLY header's)."""
    from raht3dgs_tpu_torch.io.datasets import get_pointcloud

    if device.type == "cuda" and torch.cuda.device_count() > 1:
        print(f"--batch: {torch.cuda.device_count()} CUDA devices visible; the batch "
              f"runs on {device} alone (a device mesh is ROADMAP queue A, item 18)",
              file=sys.stderr)
    frames_idx = list(range(first, last + 1))
    codecs = {}
    for start in range(0, len(frames_idx), args.batch):
        chunk = frames_idx[start:start + args.batch]
        by_depth = {}
        for fr in chunk:
            out = get_pointcloud(args.dataset, args.sequence, fr, args.data_root)
            if out is None:
                print(f"frame {fr}: load failed, skipping", file=sys.stderr)
            else:
                by_depth.setdefault(out[2], []).append((fr, out))
        if not by_depth:
            continue
        for depth, members in by_depth.items():
            _encode_depth_batch(args, members, depth, log, codecs, device)
        print(f"frames {chunk[0]}..{chunk[-1]} done (batched)")


def _encode_depth_batch(args, members, depth: int, log, codecs, device) -> None:
    """Encode one equal-depth batch of loaded frames: one transform and one
    inverse order for the batch, the pipelined step sweep, a batched decode
    per step, and one CSV row per real frame and step."""
    from raht3dgs_tpu_torch.models.batch_codec import BatchAttributeCodec, prepare_frame_batch
    from raht3dgs_tpu_torch.models.color_codec import RDPoint, y_psnr_db
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv

    dtype = torch_dtype(args.dtype)
    pos = [np.floor(np.asarray(v)).astype(np.int64) for _, (v, _, _) in members]
    yuv = [rgb_to_yuv(torch.as_tensor(np.asarray(c), device=device), dtype=dtype).cpu().numpy()
           for _, (_, c, _) in members]
    frames = prepare_frame_batch(pos, yuv, depth, bucket=args.bucket, dtype=dtype,
                                 device=device)
    if depth not in codecs:
        codecs[depth] = BatchAttributeCodec(depth, dtype=dtype, chunk=args.entropy_chunk,
                                            device=device, **quant_kwargs(args))
    bc = codecs[depth]
    coeffs, orderp, t_timer = bc.transform(frames)
    # the shared transform is amortized across the sweep: each step's rows
    # carry transform_time / n_steps, so summed stage columns still account
    # for the whole pipeline (the reporting scripts' contract)
    transform_share = {k: v / len(args.steps) for k, v in t_timer.stages.items()}
    inv = None if args.no_decode else bc.inverse_order(frames)
    refs = [f.attributes[:f.n_voxels, 0].cpu().numpy() for f in frames]
    sweep = bc.encode_sweep(frames, [float(s) for s in args.steps], coeffs=coeffs,
                            orderp=orderp)
    for step, (streams, timer) in zip(args.steps, sweep):
        for k, v in transform_share.items():
            timer.add(k, v)
        recs = None
        if not args.no_decode:
            recs, timer = bc.decode(streams, frames, timer=timer, inv=inv)
        # stage times cover the whole batch: each row takes a frame's share
        per_frame = {k: v / len(frames) for k, v in timer.stages.items()}
        for i, (fr, _) in enumerate(members):
            psnr = float("nan") if recs is None else y_psnr_db(refs[i], recs[i][:, 0])
            log.row(RDPoint(
                frame=fr, step=float(step), bpp=streams[i].bpp(), psnr=psnr,
                n_voxels=streams[i].n_voxels, stream_bytes=streams[i].payload_bytes,
                times=per_frame,
            ).csv_row())


if __name__ == "__main__":
    sys.exit(main())
