#!/usr/bin/env python3
"""Measure the inter-depth predicted RAHT mode's RD gain over plain RAHT,
on the PyTorch port.

The port's counterpart of ``scripts/rd_predict.py``: the same arguments,
workloads (``eval/synth.py``: the 56-channel 3DGS frame, a colour frame, a
body scan at J <= 9), arms and table layout:

- ``plain``        — plain RAHT + RLGR;
- ``predict``      — ``AttributeCodec(predict=True)`` (``ops/praht.py``;
  on the card the device encoder, ``ops/praht_device.py``), RLGR;
- ``predict+auto`` — prediction plus the per-channel RAC / RLGR choice.

Distortion uses the reference metric per workload (Y-PSNR against the 255
peak for colour, all-channel MSE PSNR for 3DGS); BD-rate is the
Bjontegaard cubic fit (negative = fewer bits at equal PSNR). Each arm's
wall-clocks (sweep encode, one warm step, decode a step) are host timers
around calls that return host bytes, beside the card's name.

    python scripts/torch_rd_predict.py [--n 20000] [--depth 10] \
        [--device cuda|cpu] [--out F] [--against docs/rd_predict.md]
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
    card_line,
    finish_report,
    run_line,
)


def _sweep(kwargs, frame, steps, depth, dev):
    """Returns (points, timing): the sweep's encode seconds (the first
    predicted step pays the step-independent plan, later steps reuse it),
    one more encode of a mid step on the warm cache, and the mean decode
    seconds a step."""
    import numpy as np

    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec

    codec = AttributeCodec(depth, device=dev, **kwargs)
    out = []
    dec_t = []
    t0 = time.perf_counter()
    encs = codec.encode_sweep(frame, [float(s) for s in steps])
    enc_total = time.perf_counter() - t0
    for enc in encs:
        t1 = time.perf_counter()
        rec, _ = codec.decode(enc.stream, frame.codes, frame.weights)
        dec_t.append(time.perf_counter() - t1)
        out.append((enc.stream.bpp(), rec, enc.stream.predict_mask))
    t2 = time.perf_counter()
    codec.encode(frame, float(steps[len(steps) // 2]))
    timing = {
        "enc_total_s": enc_total,
        "enc_step_s": time.perf_counter() - t2,
        "dec_step_s": float(np.mean(dec_t)),
    }
    return out, timing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=float, nargs="+",
                    default=[0.5, 1, 2, 4, 8, 16, 32])
    ap.add_argument("--color-steps", type=float, nargs="+",
                    default=[1, 2, 4, 8, 16, 32, 64])
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

    def yuv_of(rgb):
        return rgb_to_yuv(np.asarray(rgb), device=dev).cpu().numpy()

    workloads = []
    V, attrs = synthetic_gs_frame(args.n, args.depth, args.seed)
    workloads.append((
        "3DGS 56-channel", args.steps,
        prepare_voxel_frame(V.astype(np.int64), attrs, args.depth, device=dev),
        args.depth, _psnr_3dgs,
        "all-channel PSNR (encode_3dgs.py:297-299)",
    ))
    Vc, rgb = synthetic_color_frame(args.n, args.depth, args.seed)
    workloads.append((
        "color YUV (encode_ply workload)", args.color_steps,
        prepare_voxel_frame(Vc.astype(np.int64), yuv_of(rgb), args.depth, device=dev),
        args.depth, _psnr_y255,
        "Y-PSNR vs 255 peak (encode_ply.py:151-152)",
    ))
    bd_depth = min(args.depth, 9)
    Vb, rgbb = synthetic_body_scan(
        depth=bd_depth, seed=args.seed, n_frames=1, samples_per_voxel=2.0,
    )[0]
    workloads.append((
        "body-scan color (scan-like statistics)", args.color_steps,
        prepare_voxel_frame(Vb.astype(np.int64), yuv_of(rgbb), bd_depth, device=dev),
        bd_depth, _psnr_y255,
        "Y-PSNR vs 255 peak (encode_ply.py:151-152)",
    ))

    arms = [
        ("plain", {}),
        ("predict", dict(predict=True)),
        ("predict+auto", dict(predict=True, entropy="auto")),
    ]
    sections = []
    for name, steps, frame, depth, psnr_fn, metric_note in workloads:
        ref = frame.attributes[: frame.n_voxels].cpu().numpy()
        curves, masks, timings = {}, {}, {}
        for arm, kw in arms:
            pts, timings[arm] = _sweep(kw, frame, steps, depth, dev)
            curves[arm] = [(b, psnr_fn(r, ref)) for b, r, _ in pts]
            masks[arm] = [m for _, _, m in pts]
        base = curves["plain"]
        sections += [
            f"## {name}",
            "",
            f"Distortion metric: {metric_note}.",
            "",
            "| step | plain bpp | plain PSNR | predict bpp | predict "
            "PSNR | +auto bpp | +auto PSNR | mask |",
            "|---|---|---|---|---|---|---|---|",
            *(
                f"| {s:g} | {p[0]:.4f} | {p[1]:.2f} | {q[0]:.4f} | "
                f"{q[1]:.2f} | {a[0]:.4f} | {a[1]:.2f} | "
                f"{masks['predict'][i]:0{depth}b} |"
                for i, (s, p, q, a) in enumerate(zip(
                    steps, base, curves["predict"],
                    curves["predict+auto"]))
            ),
            "",
        ]
        for arm in ("predict", "predict+auto"):
            bd = bd_rate(
                [r for r, _ in base], [p for _, p in base],
                [r for r, _ in curves[arm]],
                [p for _, p in curves[arm]],
            )
            sections.append(f"**BD-rate ({arm} vs plain): {bd:+.2f}%**")
            sections.append("")
            print(f"{name} / {arm}: BD-rate {bd:+.2f}%")
        n = frame.n_voxels
        sections += [
            f"Wall-clocks ({dev.type}, {card_line(dev)}; encode sweep = "
            f"{len(steps)} steps; the first predicted step builds the "
            "step-independent plan, later steps reuse it; 'warm step' = one "
            "more encode on the warm cache, the marginal rate-search-probe "
            "cost):",
            "",
            "| arm | sweep encode s | warm step s | decode/step s | "
            "enc Mpts/s (warm) |",
            "|---|---|---|---|---|",
            *(
                f"| {arm} | {t['enc_total_s']:.2f} | {t['enc_step_s']:.2f}"
                f" | {t['dec_step_s']:.2f} | "
                f"{n / max(t['enc_step_s'], 1e-9) / 1e6:.2f} |"
                for arm, t in timings.items()
            ),
            "",
        ]
        for arm, t in timings.items():
            print(f"  {name} / {arm}: sweep {t['enc_total_s']:.2f}s, "
                  f"warm step {t['enc_step_s']:.2f}s, "
                  f"dec {t['dec_step_s']:.2f}s")

    report = "\n".join([
        "# Inter-depth predicted RAHT: measured RD gain [synthetic] (PyTorch port)",
        "",
        f"Synthetic realistic workloads (eval/synth.py), N={args.n}, "
        f"J={args.depth} (body scan J={bd_depth}), seed={args.seed}. "
        "'plain' is the reference pipeline (plain RAHT + RLGR); "
        "'predict' codes each depth group as residuals against the "
        "upsampled coarser-depth reconstruction with a per-depth "
        "signalled on/off decision (ops/praht.py); 'predict+auto' adds "
        "the per-channel RAC/RLGR entropy choice. BD-rate < 0 = fewer "
        "bits at equal PSNR (Bjontegaard cubic fit).",
        "",
        run_line("torch_rd_predict.py", dev, t0),
        "",
        *sections,
    ])
    return finish_report(args, report)


if __name__ == "__main__":
    raise SystemExit(main())
