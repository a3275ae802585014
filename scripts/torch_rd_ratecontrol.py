#!/usr/bin/env python3
"""Rate-control tracking accuracy of the PyTorch port: how tightly
``--target-bpp`` lands.

The port's counterpart of ``scripts/rd_ratecontrol.py``: the same
arguments, workloads (a body-scan sequence and a deforming textured
surface, ``eval/synth.py``), arms (intra ``search_step_for_bpp``, the
sequence-global leaky bucket ``RateController``, the two-pass
``search_global_step_for_bpp``, the temporal
``SequenceCodec.encode_frame_target``), assertions (no frame over its
budget, no prefix over the target) and table layout.

    python scripts/torch_rd_ratecontrol.py [--device cuda|cpu] [--out F] \
        [--against docs/rd_ratecontrol.md]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_rd_deadzone import (  # noqa: E402
    add_port_args,
    finish_report,
    run_line,
)

_TABLE_HEAD = ("| target bpp | intra mean bpp | intra max over "
               "| intra Y-PSNR | +cbr mean bpp | +cbr Y-PSNR "
               "| 2pass mean bpp | 2pass Y-PSNR | PSNR spread cbr/2p "
               "| inter mean bpp | inter max over "
               "| inter Y-PSNR | frame kinds |")
_TABLE_SEP = "|---|---|---|---|---|---|---|---|---|---|---|---|---|"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--budgets", type=float, nargs="+",
                    default=[1.0, 2.0, 4.0, 8.0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    add_port_args(ap)
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    from raht3dgs_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)

    import numpy as np

    from raht3dgs_tpu_torch.eval.synth import synthetic_body_scan, synthetic_color_sequence
    from raht3dgs_tpu_torch.models.pipeline import prepare_voxel_frame
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv

    def build(seq):
        out = []
        for V, rgb in seq:
            yuv = rgb_to_yuv(rgb.astype(np.float64), device=dev).cpu().numpy()
            out.append(prepare_voxel_frame(V.astype(np.int64), yuv, args.depth, device=dev))
        return out

    workloads = [
        ("body scan (fast per-frame scan noise — the adaptive fallback "
         "should pick intra)", build(synthetic_body_scan(
             depth=args.depth, seed=args.seed, n_frames=args.frames,
             samples_per_voxel=2.0, phase_rate=0.15,
         ))),
        ("deforming textured surface (persistent texture — P-frames "
         "should win)", build(synthetic_color_sequence(
             n_frames=args.frames, depth=args.depth, seed=args.seed,
         ))),
    ]

    report_rows = []
    for wname, frames in workloads:
        n_mean = int(np.mean([f.n_voxels for f in frames]))
        print(f"{wname}: {len(frames)} frames, ~{n_mean} voxels, "
              f"J={args.depth}")
        rows = _sweep_budgets(args, frames, dev)
        report_rows += ["", f"## {wname} (~{n_mean} voxels/frame)", "",
                        _TABLE_HEAD, _TABLE_SEP, *rows]

    report = "\n".join([
        "# Rate-control tracking (--target-bpp) (PyTorch port)",
        "",
        f"Synthetic sequences (eval/synth.py), {args.frames} frames each, "
        f"J={args.depth}. For each budget, every frame is encoded through "
        "the rate-targeted intra path and the rate-controlled temporal "
        "path (`SequenceCodec.encode_frame_target`). The contract is "
        "one-sided: actual <= target on EVERY frame ('max over' = worst "
        "per-frame overshoot, must be <= 0). The `+cbr` columns re-run the "
        "intra path through the sequence-global leaky-bucket allocator "
        "(`--cbr`, models/rate_control.py); the `2pass` columns run the "
        "constant-quality allocator (`--two-pass`, one shared step for the "
        "whole sequence). `[synthetic]` content.",
        "",
        run_line("torch_rd_ratecontrol.py", dev, t0),
        *report_rows,
    ])
    print()
    print("OK: no frame exceeded its budget")
    return finish_report(args, report)


def _sweep_budgets(args, frames, dev):
    import numpy as np

    from raht3dgs_tpu_torch.models.color_codec import y_psnr_db
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec
    from raht3dgs_tpu_torch.models.rate_control import RateController
    from raht3dgs_tpu_torch.models.rd_search import (
        search_global_step_for_bpp,
        search_step_for_bpp,
    )
    from raht3dgs_tpu_torch.models.temporal import SequenceCodec

    def y_psnr(f, rec):
        return y_psnr_db(f.attributes[: f.n_voxels, 0].cpu().numpy(), rec[:, 0])

    rows = []
    for budget in args.budgets:
        # intra rate targeting (the encode_ply / encode_dataset path)
        codec = AttributeCodec(args.depth, device=dev)
        intra_bpp, intra_psnr = [], []
        for f in frames:
            r = search_step_for_bpp(f, budget, codec=codec)
            rec, _ = codec.decode(r.encoded.stream, f.codes, f.weights)
            intra_bpp.append(r.bpp)
            intra_psnr.append(y_psnr(f, rec))
        # sequence-global CBR (encode_dataset --target-bpp --cbr): the credit
        # carry must close the underspend without breaking any prefix
        rc = RateController(budget)
        cbr_bpp, cbr_psnr = [], []
        for f in frames:
            r = search_step_for_bpp(f, rc.frame_budget(), codec=codec)
            rc.update(r.bpp)
            rec, _ = codec.decode(r.encoded.stream, f.codes, f.weights)
            cbr_bpp.append(r.bpp)
            cbr_psnr.append(y_psnr(f, rec))
            assert np.mean(cbr_bpp) <= budget + 1e-9, "prefix overshoot!"
        # carrying credit spends at least what independent budgets did
        assert np.mean(cbr_bpp) >= np.mean(intra_bpp) - 1e-9
        # two-pass constant-quality allocation (--target-bpp --two-pass)
        gres = search_global_step_for_bpp(frames, budget, codec=codec)
        tp_bpp, tp_psnr = [], []
        for f, enc in zip(frames, gres.encoded):
            rec, _ = codec.decode(enc.stream, f.codes, f.weights)
            tp_bpp.append(enc.stream.bpp())
            tp_psnr.append(y_psnr(f, rec))
        assert gres.total_bpp <= budget + 1e-9, "sequence overshoot!"
        # temporal rate targeting (encode_dataset --target-bpp --inter)
        sc = SequenceCodec(args.depth, gop=8, device=dev)
        inter_bpp, inter_psnr, kinds = [], [], []
        for f in frames:
            stream, rec, _step = sc.encode_frame_target(f, budget)
            inter_bpp.append(stream.bpp())
            inter_psnr.append(y_psnr(f, np.asarray(rec)))
            kinds.append("P" if stream.inter else "I")
        over_i = max(b - budget for b in intra_bpp)
        over_t = max(b - budget for b in inter_bpp)
        rows.append(
            f"| {budget:g} "
            f"| {np.mean(intra_bpp):.3f} | {over_i:+.4f} "
            f"| {np.mean(intra_psnr):.2f} "
            f"| {np.mean(cbr_bpp):.3f} | {np.mean(cbr_psnr):.2f} "
            f"| {np.mean(tp_bpp):.3f} | {np.mean(tp_psnr):.2f} "
            f"| {np.ptp(cbr_psnr):.2f}/{np.ptp(tp_psnr):.2f} "
            f"| {np.mean(inter_bpp):.3f} | {over_t:+.4f} "
            f"| {np.mean(inter_psnr):.2f} | {''.join(kinds)} |"
        )
        print(rows[-1])
        assert over_i <= 1e-9 and over_t <= 1e-9, "budget overshoot!"
    return rows


if __name__ == "__main__":
    sys.exit(main())
