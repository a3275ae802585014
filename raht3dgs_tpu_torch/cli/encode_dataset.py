"""Dataset RD-sweep CLI (reference: python/encode_dataset.py).

Counterpart of ``raht3dgs_tpu/cli/encode_dataset.py``: loops the colour
codec over the frames of an 8iVFBv2/MVUB sequence, each frame's depth from
its PLY header, logging the reference 11-column CSV; with ``--batch B`` it
encodes B frames per call through the batched codec
(``models/batch_codec.py``), sharded over every visible card (frames over
dp) when there is more than one. Runs on CUDA unless ``--platform cpu``.
Example:

    python -m raht3dgs_tpu_torch.cli.encode_dataset --dataset 8iVFBv2 \\
        --sequence redandblack --data-root /data --frames 1 10 --batch 4

``--entropy rac|auto`` picks the attribute coder per channel, and
``--predict`` codes inter-depth predicted RAHT, in the frame loop and
under ``--batch`` (where each frame runs its own closed loop).
``--target-bpp T`` searches each frame's step for a rate budget
(``models/rd_search.py``, one CSV row a frame); ``--cbr`` (with
``--cbr-burst`` and ``--cbr-gop``) carries each frame's unspent budget
forward (``models/rate_control.py``), and ``--two-pass`` finds one step for
the whole range. ``--save-sequence S`` writes every frame's stream into
one indexed ``.r3ts`` file (one step), in every mode; ``--code-geometry``
then attaches each frame's lossless geometry. ``--inter`` codes I/P frames
through ``models/temporal.py`` (``--gop``, ``--search-stride``, and with
``--target-bpp`` a step searched per candidate), P-frames carrying
temporal geometry under ``--code-geometry``. ``--tiles D`` (with
``--save-sequence`` and one ``--steps`` value, intra only) writes each frame
as a self-contained tiled ``.r3tt`` blob inside the ``.r3ts``, so any frame
decodes by index with ``--roi``.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

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
        help="write all frames to one indexed .r3ts sequence file "
        "(requires exactly one --steps value)",
    )
    p.add_argument(
        "--batch", type=int, default=0,
        help="encode this many frames per call through the batched codec "
        "(0 = frame loop); one device",
    )
    p.add_argument(
        "--target-bpp", type=float, default=None,
        help="instead of a step sweep, search each frame's quantization step "
        "for this rate budget (the device rate model and true-encode "
        "refinement, models/rd_search.py); not with --batch",
    )
    p.add_argument(
        "--cbr", action="store_true",
        help="with --target-bpp: leaky-bucket allocation — carry each frame's "
        "unspent budget forward as credit (capped at --cbr-burst), keeping "
        "cumulative spend <= n*target at every prefix (models/rate_control.py)",
    )
    p.add_argument(
        "--cbr-burst", type=float, default=None,
        help="with --cbr: bucket depth in bpp, the most credit carried across "
        "frames (default: one frame's budget)",
    )
    p.add_argument(
        "--cbr-gop", type=int, default=0,
        help="with --cbr: reset the carried credit every K frames, so each GOP "
        "meets the prefix invariant on its own",
    )
    p.add_argument(
        "--two-pass", action="store_true",
        help="with --target-bpp: one shared step for the whole range, the "
        "finest whose total rate fits sum(n)*target "
        "(search_global_step_for_bpp); not with --cbr/--inter/--batch",
    )
    p.add_argument(
        "--tiles", type=int, default=0, metavar="D",
        help="write each frame as a tiled .r3tt blob of octree bricks at depth "
        "D inside the --save-sequence file (spatio-temporal random access: "
        "decode --frame-index K --roi ...); intra only, one --steps value",
    )
    p.add_argument(
        "--inter", action="store_true",
        help="temporal I/P coding: predict each frame from the previous "
        "reconstruction and code the residual (closed loop, adaptive "
        "per-frame intra fallback; requires exactly one --steps value)",
    )
    p.add_argument("--gop", type=int, default=16,
                   help="with --inter: force an intra frame every GOP frames")
    p.add_argument(
        "--search-stride", type=int, default=None,
        help="with --inter: encoder-side motion-search witness sampling "
        "stride (default: exact below 65536 voxels, 4 above; the field is "
        "signalled, so any stride decodes alike; 1 = exact everywhere)",
    )
    add_geometry_arg(p)
    add_quant_args(p)
    add_runtime_args(p)
    return p


def _err(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 2


def _refusals(args):
    """The JAX CLI's argument errors (``2``) in its dispatch order; None when
    the run may go on."""
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
    elif args.two_pass:
        if args.target_bpp is None:
            return _err("--two-pass is a rate-control mode; it requires --target-bpp")
        if args.cbr or args.cbr_burst is not None or args.inter or args.batch:
            return _err("--two-pass allocates the whole sequence at once; it "
                        "composes with --save-sequence/--code-geometry but not "
                        "with --cbr/--inter/--batch")
    elif args.target_bpp is not None:
        if args.batch:
            return _err("--target-bpp composes with the frame loop or --inter "
                        "(drop --batch)")
    elif args.inter:
        if len(args.steps) != 1:
            return _err("--inter requires exactly one --steps value")
        if args.batch:
            return _err("--inter is sequential by nature; drop --batch")
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
    seq = []  # the streams --save-sequence writes, in frame order
    rc = 0
    # context managers: the trace and the CSV finish even when a frame raises
    with maybe_profile(args, device), contextlib.closing(log):
        if args.tiles:
            rc = _run_tiled(args, first, last, log, device, seq)
        elif args.two_pass:
            rc = _run_two_pass(args, first, last, log, device, seq)
        elif args.inter:
            _run_inter(args, first, last, log, device, seq)
        elif args.target_bpp is not None:
            _run_target(args, first, last, log, device, seq)
        elif args.batch > 0:
            _run_batched(args, first, last, log, device, seq)
        else:
            _run_frames(args, first, last, log, device, seq)
    if rc != 0:
        return rc
    if args.save_sequence:
        from raht3dgs_tpu_torch.codec.bitstream import write_sequence

        total = write_sequence(args.save_sequence, seq)
        kind = "tiled frames" if args.tiles else "frames"
        print(f"sequence: {len(seq)} {kind}, {total} bytes -> {args.save_sequence}")
    return 0


def _intra_geometry(args, V, depth: int):
    """The frame's intra geometry section when ``--save-sequence
    --code-geometry`` asks for one, else None. Intra geometry per frame keeps
    any frame of an all-intra sequence decodable alone; temporal geometry
    rides ``--inter`` P-frames only."""
    if not (args.code_geometry and args.save_sequence):
        return None
    from raht3dgs_tpu_torch.codec.geometry import geometry_from_positions

    return geometry_from_positions(V, depth)


def _run_tiled(args, first: int, last: int, log, device, seq) -> int:
    """Tiled intra sequence: one self-contained .r3tt blob per frame in
    ``seq`` (every frame then decodes with --roi); one CSV row a frame, its
    Y-PSNR through a full tiled decode."""
    from raht3dgs_tpu_torch.io.datasets import get_pointcloud
    from raht3dgs_tpu_torch.models.color_codec import RDPoint, y_psnr_db
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec
    from raht3dgs_tpu_torch.models.tiling import decode_tiled_frame, encode_tiled_frame
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv
    from raht3dgs_tpu_torch.ops.morton import morton_codes_np

    dtype = torch_dtype(args.dtype)
    step = args.steps[0]
    codecs = {}
    for frame in range(first, last + 1):
        out = get_pointcloud(args.dataset, args.sequence, frame, args.data_root)
        if out is None:
            print(f"frame {frame}: load failed, skipping", file=sys.stderr)
            continue
        V, C, depth = out
        if not 0 < args.tiles < depth:
            return _err(f"--tiles must be in (0, {depth}) for this sequence's depth")
        if depth not in codecs:
            codecs[depth] = AttributeCodec(depth, dtype=dtype, chunk=args.entropy_chunk,
                                           device=device, **quant_kwargs(args))
        t0 = time.perf_counter()
        Vi = np.floor(np.asarray(V)).astype(np.int64)
        yuv = rgb_to_yuv(torch.as_tensor(np.asarray(C), device=device),
                         dtype=dtype).cpu().numpy()
        blob, stats = encode_tiled_frame(Vi, yuv, depth, args.tiles, codecs[depth], step,
                                         code_geometry=True)
        enc_s = time.perf_counter() - t0
        psnr = float("nan")
        if not args.no_decode:
            _, Ad = decode_tiled_frame(blob, dtype=dtype, device=device)
            order = np.argsort(morton_codes_np(Vi, depth), kind="stable")
            psnr = y_psnr_db(yuv[order][:, 0], Ad[:, 0])
        n = len(Vi)
        print(f"frame {frame}: {len(stats)} tiles, {len(blob)} B = "
              f"{8 * len(blob) / n:.4f} bpp, Y-PSNR {psnr:.2f} dB")
        log.row(RDPoint(frame=frame, step=float(step), bpp=8 * len(blob) / n, psnr=psnr,
                        n_voxels=n, stream_bytes=len(blob),
                        times={"Entropy_enc_time": enc_s}).csv_row())
        seq.append(blob)
    return 0


def _run_frames(args, first: int, last: int, log, device, seq) -> None:
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
        geom = _intra_geometry(args, V, depth)
        for pt in encode_color_frame(
            V, C, depth=depth, steps=args.steps, frame_index=frame,
            codec=codecs[depth], bucket=args.bucket, dtype=dtype,
            decode=not args.no_decode, keep_streams=bool(args.save_sequence),
        ):
            log.row(pt.csv_row())
            if pt.encoded is not None:
                pt.encoded.stream.geometry = geom
                seq.append(pt.encoded.stream)
        print(f"frame {frame} done")


def _run_batched(args, first: int, last: int, log, device, seq) -> None:
    """Batched path: ``--batch`` frames per call, sharded over the local
    device mesh when more than one device exists, each chunk split into
    equal-depth batches (a frame's depth is its PLY header's)."""
    from raht3dgs_tpu_torch.io.datasets import get_pointcloud
    from raht3dgs_tpu_torch.parallel import sharding

    devices = sharding.local_devices(device)
    n_dev = len(devices)
    mesh = sharding.make_mesh(n_dev, dp=n_dev, tp=1, devices=devices) if n_dev > 1 else None
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
            _encode_depth_batch(args, members, depth, log, codecs, device, seq, mesh)
        print(f"frames {chunk[0]}..{chunk[-1]} done (batched)")


def _encode_depth_batch(args, members, depth: int, log, codecs, device, seq, mesh) -> None:
    """Encode one equal-depth batch of loaded frames: one transform and one
    inverse order for the batch, the pipelined step sweep, a batched decode
    per step, and one CSV row per real frame and step; with
    ``--save-sequence`` each step's streams go to ``seq`` in frame order.
    On a ``mesh`` the batch is padded to a multiple of dp with copies of its
    last frame, which are encoded and dropped from every output."""
    from raht3dgs_tpu_torch.models.batch_codec import BatchAttributeCodec, prepare_frame_batch
    from raht3dgs_tpu_torch.models.color_codec import RDPoint, y_psnr_db
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv
    from raht3dgs_tpu_torch.utils.timing import StageTimer

    dtype = torch_dtype(args.dtype)
    n_real = len(members)
    padded = list(members)
    while mesh is not None and len(padded) % mesh.shape["dp"]:
        padded.append(padded[-1])
    pos = [np.floor(np.asarray(v)).astype(np.int64) for _, (v, _, _) in padded]
    yuv = [rgb_to_yuv(torch.as_tensor(np.asarray(c), device=device), dtype=dtype).cpu().numpy()
           for _, (_, c, _) in padded]
    frames = prepare_frame_batch(pos, yuv, depth, bucket=args.bucket, dtype=dtype,
                                 device=device)
    if depth not in codecs:
        codecs[depth] = BatchAttributeCodec(depth, dtype=dtype, chunk=args.entropy_chunk,
                                            mesh=mesh, device=device, **quant_kwargs(args))
    bc = codecs[depth]
    # a predicted codec runs each frame's own closed loop and decodes frame
    # by frame: the batched transform and inverse order would go unused
    coeffs = orderp = inv = None
    t_timer = StageTimer()
    if not bc.predict:
        coeffs, orderp, t_timer = bc.transform(frames)
        inv = None if args.no_decode else bc.inverse_order(frames)
    # the shared transform is amortized across the sweep: each step's rows
    # carry transform_time / n_steps, so summed stage columns still account
    # for the whole pipeline (the reporting scripts' contract)
    transform_share = {k: v / len(args.steps) for k, v in t_timer.stages.items()}
    refs = [f.attributes[:f.n_voxels, 0].cpu().numpy() for f in frames]
    geoms = [_intra_geometry(args, p, depth) for p in pos[:n_real]]
    sweep = bc.encode_sweep(frames, [float(s) for s in args.steps], coeffs=coeffs,
                            orderp=orderp)
    for step, (streams, timer) in zip(args.steps, sweep):
        for k, v in transform_share.items():
            timer.add(k, v)
        recs = None
        if not args.no_decode:
            recs, timer = bc.decode(streams, frames, timer=timer, inv=inv)
        if args.save_sequence:
            for st, g in zip(streams, geoms):
                st.geometry = g
            seq.extend(streams[:n_real])
        # stage times cover the whole batch: each row takes a frame's share
        per_frame = {k: v / len(frames) for k, v in timer.stages.items()}
        for i, (fr, _) in enumerate(members):
            psnr = float("nan") if recs is None else y_psnr_db(refs[i], recs[i][:, 0])
            log.row(RDPoint(
                frame=fr, step=float(step), bpp=streams[i].bpp(), psnr=psnr,
                n_voxels=streams[i].n_voxels, stream_bytes=streams[i].payload_bytes,
                times=per_frame,
            ).csv_row())


def _make_controller(args):
    """The sequence-global allocator for --cbr, else None (independent
    per-frame budgets)."""
    if not (args.cbr or args.cbr_burst is not None or args.cbr_gop):
        return None
    from raht3dgs_tpu_torch.models.rate_control import RateController

    return RateController(args.target_bpp, burst=args.cbr_burst)


def _yuv_frame(args, V, C, depth: int, device):
    """A loaded frame as the rate paths code it: YUV attributes on the
    floored voxel grid, at the CLI's bucket and dtype."""
    from raht3dgs_tpu_torch.models.pipeline import prepare_voxel_frame
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv

    dtype = torch_dtype(args.dtype)
    yuv = rgb_to_yuv(torch.as_tensor(np.asarray(C), device=device), dtype=dtype).cpu().numpy()
    return prepare_voxel_frame(np.floor(np.asarray(V)).astype(np.int64), yuv, depth,
                               bucket=args.bucket, dtype=dtype, device=device)


def _y_psnr(codec, stream, fr) -> float:
    from raht3dgs_tpu_torch.models.color_codec import y_psnr_db

    rec, _ = codec.decode(stream, fr.codes, fr.weights)
    return y_psnr_db(fr.attributes[:fr.n_voxels, 0].cpu().numpy(), rec[:, 0])


def _run_target(args, first: int, last: int, log, device, seq) -> None:
    """Constant-rate sequence encoding: search each frame's step for the
    --target-bpp budget (or the --cbr controller's), decode it for its
    Y-PSNR, and log one CSV row a frame."""
    from raht3dgs_tpu_torch.io.datasets import get_pointcloud
    from raht3dgs_tpu_torch.models.color_codec import RDPoint
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec
    from raht3dgs_tpu_torch.models.rd_search import search_step_for_bpp

    dtype = torch_dtype(args.dtype)
    codecs = {}
    rc = _make_controller(args)
    for frame_idx in range(first, last + 1):
        out = get_pointcloud(args.dataset, args.sequence, frame_idx, args.data_root)
        if out is None:
            print(f"frame {frame_idx}: load failed, skipping", file=sys.stderr)
            continue
        V, C, depth = out
        if depth not in codecs:
            codecs[depth] = AttributeCodec(depth, dtype=dtype, chunk=args.entropy_chunk,
                                           device=device, **quant_kwargs(args))
        codec = codecs[depth]
        t0 = time.perf_counter()
        fr = _yuv_frame(args, V, C, depth, device)
        if rc is not None and args.cbr_gop > 0 and (frame_idx - first) % args.cbr_gop == 0:
            rc.reset_credit()
        budget = rc.frame_budget() if rc is not None else args.target_bpp
        res = search_step_for_bpp(fr, budget, codec=codec)
        if rc is not None:
            rc.update(res.bpp)
        search_s = time.perf_counter() - t0
        psnr = _y_psnr(codec, res.encoded.stream, fr)
        cbr = f", cum {rc.mean_bpp:.4f}, credit {rc.credit:.4f}" if rc is not None else ""
        print(f"frame {frame_idx}: budget {budget:.3f} bpp -> step {res.step:.4f}, "
              f"actual {res.bpp:.4f} bpp{cbr}, Y-PSNR {psnr:.2f} dB ({res.probes} device "
              f"probes, {search_s:.2f}s)")
        log.row(RDPoint(
            frame=frame_idx, step=float(res.step), bpp=res.bpp, psnr=psnr,
            n_voxels=fr.n_voxels, stream_bytes=res.encoded.stream.payload_bytes,
            times={"Quant_time": search_s},
        ).csv_row())
        if args.save_sequence:
            res.encoded.stream.geometry = _intra_geometry(args, V, depth)
            seq.append(res.encoded.stream)


def _run_two_pass(args, first: int, last: int, log, device, seq) -> int:
    """Constant-quality sequence allocation under a total-rate cap: one
    shared step for every frame (``search_global_step_for_bpp``). Loads and
    prepares the whole range first: the allocator needs every frame's rate
    curve before the first byte is spent."""
    from raht3dgs_tpu_torch.io.datasets import get_pointcloud
    from raht3dgs_tpu_torch.models.color_codec import RDPoint
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec
    from raht3dgs_tpu_torch.models.rd_search import search_global_step_for_bpp

    t0 = time.perf_counter()
    frames, metas = [], []
    for frame_idx in range(first, last + 1):
        out = get_pointcloud(args.dataset, args.sequence, frame_idx, args.data_root)
        if out is None:
            print(f"frame {frame_idx}: load failed, skipping", file=sys.stderr)
            continue
        V, C, depth = out
        frames.append(_yuv_frame(args, V, C, depth, device))
        metas.append((frame_idx, V, depth))
    if not frames:
        print("no frames loaded", file=sys.stderr)
        return 1
    depths = {d for _, _, d in metas}
    if len(depths) > 1:
        return _err(f"--two-pass needs one octree depth across the range, got "
                    f"{sorted(depths)} (encode per-depth subranges, or use the "
                    "per-frame --target-bpp search)")
    codec = AttributeCodec(metas[0][2], dtype=torch_dtype(args.dtype),
                           chunk=args.entropy_chunk, device=device, **quant_kwargs(args))
    res = search_global_step_for_bpp(frames, args.target_bpp, codec=codec)
    search_s = time.perf_counter() - t0
    print(f"two-pass: step {res.step:.4f} for {len(frames)} frames, sequence "
          f"{res.total_bpp:.4f} bpp vs target {args.target_bpp:.3f} ({res.probes} "
          f"device probes, {search_s:.2f}s)")
    for (frame_idx, V, depth), fr, enc in zip(metas, frames, res.encoded):
        psnr = _y_psnr(codec, enc.stream, fr)
        print(f"frame {frame_idx}: {enc.stream.bpp():.4f} bpp, Y-PSNR {psnr:.2f} dB")
        log.row(RDPoint(
            frame=frame_idx, step=float(res.step), bpp=enc.stream.bpp(), psnr=psnr,
            n_voxels=fr.n_voxels, stream_bytes=enc.stream.payload_bytes,
            times={"Quant_time": search_s / len(frames)},
        ).csv_row())
        if args.save_sequence:
            enc.stream.geometry = _intra_geometry(args, V, depth)
            seq.append(enc.stream)
    return 0


def _run_inter(args, first: int, last: int, log, device, seq) -> None:
    """Temporal I/P coding: frames stream through ``SequenceCodec``'s
    incremental API, the closed-loop state carried across frames; one CSV
    row a frame, the PSNR of the decoder-exact reconstruction. With
    ``--target-bpp`` each candidate searches its own step (``--cbr``
    allocating the budgets)."""
    from raht3dgs_tpu_torch.codec.geometry import encode_geometry
    from raht3dgs_tpu_torch.io.datasets import get_pointcloud
    from raht3dgs_tpu_torch.models.color_codec import RDPoint, y_psnr_db
    from raht3dgs_tpu_torch.models.temporal import SequenceCodec, signalled_global_motion
    from raht3dgs_tpu_torch.ops.morton import codes_to_host
    from raht3dgs_tpu_torch.utils.timing import StageTimer

    dtype = torch_dtype(args.dtype)
    step = args.steps[0] if args.target_bpp is None else None
    rc = _make_controller(args) if args.target_bpp is not None else None
    codecs = {}
    geom_prev = (None, None)  # (codes, depth) of the last saved frame
    n_inter = n_done = 0
    prev_depth = None
    for frame_idx in range(first, last + 1):
        out = get_pointcloud(args.dataset, args.sequence, frame_idx, args.data_root)
        if out is None:
            print(f"frame {frame_idx}: load failed, skipping", file=sys.stderr)
            continue
        V, C, depth = out
        if depth not in codecs:
            codecs[depth] = SequenceCodec(depth, gop=args.gop, chunk=args.entropy_chunk,
                                          dtype=dtype, search_stride=args.search_stride,
                                          device=device, **quant_kwargs(args))
        sc = codecs[depth]
        # predictions chain only across consecutive same-depth frames; the
        # decoder (cli/decode.py) breaks the chain by the same rule
        if prev_depth != depth:
            sc.reset()
        prev_depth = depth
        frame = _yuv_frame(args, V, C, depth, device)
        timer = StageTimer()
        if args.target_bpp is not None:
            if rc is not None and args.cbr_gop > 0 and (frame_idx - first) % args.cbr_gop == 0:
                rc.reset_credit()
            budget = rc.frame_budget() if rc is not None else args.target_bpp
            stream, rec, used_step = sc.encode_frame_target(frame, budget, timer=timer)
            if rc is not None:
                rc.update(stream.bpp())
        else:
            stream, rec = sc.encode_frame(frame, step, timer=timer)
            used_step = step
        n_inter += bool(stream.inter)
        n_done += 1
        psnr = y_psnr_db(frame.attributes[:frame.n_voxels, 0].cpu().numpy(), rec[:, 0])
        pt = RDPoint(frame=frame_idx, step=float(used_step), bpp=stream.bpp(), psnr=psnr,
                     n_voxels=frame.n_voxels, stream_bytes=stream.payload_bytes,
                     times=timer.stages)
        log.row(pt.csv_row())
        kind = "P" if stream.inter else "I"
        cbr = f", cum {rc.mean_bpp:.4f}, credit {rc.credit:.4f}" if rc is not None else ""
        print(f"frame {frame_idx} [{kind}] step {used_step:g}: {pt.bpp:.4f} bpp{cbr}, "
              f"Y-PSNR {psnr:.2f} dB ({frame.n_voxels} voxels)")
        if args.save_sequence:
            if args.code_geometry:
                # temporal geometry rides P-frames only, compensated by the
                # stream's signalled global motion (profile 2); I-frames
                # restart the chain, so every GOP boundary is an entry point
                cur_codes = codes_to_host(frame.codes[:frame.n_voxels], depth)
                use_prev = stream.inter and geom_prev[1] == depth
                stream.geometry = encode_geometry(
                    cur_codes, depth, prev_codes=geom_prev[0] if use_prev else None,
                    motion=signalled_global_motion(stream) if use_prev else None)
                geom_prev = (cur_codes, depth)
            seq.append(stream)
    print(f"inter frames: {n_inter}/{n_done}")


if __name__ == "__main__":
    sys.exit(main())
