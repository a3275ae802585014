#!/usr/bin/env python3
"""Measure the dead-zone quantizer's RD gain over the reference quantizer,
on the PyTorch port.

The port's counterpart of ``scripts/rd_deadzone.py``: the same arguments,
workloads (``eval/synth.py``: the 56-channel 3DGS frame, a 3-channel
colour cloud, an articulated body scan), arms ("mid", the reference's
round-half-up, against the opt-in "deadzone" path) and table layout, with
the BD-rate of each workload (negative = deadzone spends fewer bits).
It also holds the helpers the other port RD tools import: ``bd_rate``,
``_psnr_3dgs``, ``_psnr_y255``, ``_sweep`` and the device / output
plumbing (``add_port_args``, ``finish_report``).

    python scripts/torch_rd_deadzone.py [--n 20000] [--depth 10] \
        [--f 0.3] [--delta 0.12] [--device cuda|cpu] [--out F] [--against D]
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def bd_rate(rate_a, psnr_a, rate_b, psnr_b) -> float:
    """Bjontegaard delta rate of curve B vs curve A, in percent.

    Standard method: cubic fit of log-rate as a function of PSNR for each
    curve, integrate both over the overlapping PSNR interval, convert the
    mean log-rate gap back to a percentage. Negative = B cheaper."""
    import numpy as np

    la, lb = np.log(np.asarray(rate_a)), np.log(np.asarray(rate_b))
    pa, pb = np.asarray(psnr_a), np.asarray(psnr_b)
    deg = min(3, len(pa) - 1, len(pb) - 1)
    fa = np.polynomial.polynomial.Polynomial.fit(pa, la, deg)
    fb = np.polynomial.polynomial.Polynomial.fit(pb, lb, deg)
    lo = max(pa.min(), pb.min())
    hi = min(pa.max(), pb.max())
    if hi <= lo:
        raise ValueError("RD curves do not overlap in PSNR")
    ia = fa.integ()
    ib = fb.integ()
    avg = ((ib(hi) - ib(lo)) - (ia(hi) - ia(lo))) / (hi - lo)
    return (math.exp(avg) - 1.0) * 100.0


def _psnr_3dgs(rec, ref):
    """Reference 3DGS metric: all-channel MSE-based PSNR
    (the reference's ``encode_3dgs.py:297-299``)."""
    import numpy as np

    mse = float(np.mean((rec - ref) ** 2))
    return -10.0 * math.log10(mse + 1e-10)


def _psnr_y255(rec, ref):
    """Reference colour metric: Y-channel PSNR against the 255 peak (the
    reference's ``encode_ply.py:151-152``, computed there on the Y
    coefficients' quantization error, which by RAHT orthonormality equals
    this signal-domain Y MSE)."""
    import numpy as np

    mse = float(np.mean((rec[:, 0] - ref[:, 0]) ** 2))
    return -10.0 * math.log10(mse / 255.0**2 + 1e-12)


def _sweep(codec_cls_kwargs, frame, steps, codec_factory, psnr_fn):
    """(bpp, psnr) per step for one codec configuration."""
    codec = codec_factory(**codec_cls_kwargs)
    coeffs, order, _, _ = codec.transform(frame)
    ref = frame.attributes[: frame.n_voxels].cpu().numpy()
    out = []
    for enc in codec.encode_sweep(frame, steps, coeffs=coeffs, order=order):
        rec, _ = codec.decode(enc.stream, frame.codes, frame.weights)
        out.append((enc.stream.bpp(), psnr_fn(rec, ref)))
    return out


# -- the port tools' shared plumbing ------------------------------------------

def add_port_args(ap) -> None:
    """``--device`` (CUDA unless ``cpu``; without a card it raises),
    ``--against`` (the JAX document to hold the output against) and
    ``--psnr-tol`` (the comparison's PSNR tolerance)."""
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the port runs (default cuda; raises without a card)")
    ap.add_argument("--against", default=None,
                    help="the JAX package's RD document to compare the tables "
                    "with (scripts/torch_rd_against.py); exits nonzero on a "
                    "difference")
    ap.add_argument("--psnr-tol", type=float, default=0.0,
                    help="how far a PSNR cell may stray from the document's, "
                    "as printed (default 0: equal)")


def card_line(dev) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``CPU`` for a run on the CPU."""
    if dev.type != "cuda":
        return "CPU"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run_line(tool: str, dev, t0: float) -> str:
    """The line a port RD document's header gives its run: tool, device, card,
    wall seconds and the scan kernel's launches counted in this process."""
    from raht3dgs_tpu_torch.ops.ds_scan import LAUNCHES

    launches = ", ".join(f"{k} {v}" for k, v in LAUNCHES.items())
    return (f"Port run: `scripts/{tool}` on {dev.type} ({card_line(dev)}), "
            f"{time.perf_counter() - t0:.1f} s wall; scan kernel launches in this "
            f"process: {launches}.")


def finish_report(args, report: str, mode: str = "w") -> int:
    """Write ``report`` to ``--out`` (``mode`` "a" appends), then with
    ``--against`` compare the written document with the JAX one and append
    the verdict. Returns the tool's exit code."""
    from torch_rd_against import against

    text = report if report.endswith("\n") else report + "\n"
    if args.out:
        with open(args.out, mode) as f:
            f.write(text)
        with open(args.out) as f:
            text = f.read()
        print(f"wrote {args.out}")
    if not args.against:
        return 0
    ok, section = against(args.against, text, psnr_tol=args.psnr_tol)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n" + section)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--f", type=float, default=0.3,
                    help="dead-zone encoder rounding offset")
    ap.add_argument("--delta", type=float, default=0.12,
                    help="dead-zone reconstruction offset")
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
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec, prepare_voxel_frame
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv

    def yuv_of(rgb):
        return rgb_to_yuv(np.asarray(rgb), device=dev).cpu().numpy()

    dz_kw = dict(quant_mode="deadzone", quant_f=args.f,
                 rec_delta=args.delta)

    workloads = []
    V, attrs = synthetic_gs_frame(args.n, args.depth, args.seed)
    workloads.append((
        "3DGS 56-channel", args.steps,
        prepare_voxel_frame(V.astype(np.int64), attrs, args.depth, device=dev),
        args.depth, _psnr_3dgs, "all-channel PSNR (encode_3dgs.py:297-299)",
    ))
    Vc, rgb = synthetic_color_frame(args.n, args.depth, args.seed)
    workloads.append((
        "color YUV (encode_ply workload)", args.color_steps,
        prepare_voxel_frame(Vc.astype(np.int64), yuv_of(rgb), args.depth, device=dev),
        args.depth, _psnr_y255, "Y-PSNR vs 255 peak (encode_ply.py:151-152)",
    ))
    Vb, rgbb = synthetic_body_scan(
        depth=min(args.depth, 9), seed=args.seed, n_frames=1,
        samples_per_voxel=2.0,
    )[0]
    workloads.append((
        "body-scan color (scan-like statistics)", args.color_steps,
        prepare_voxel_frame(Vb.astype(np.int64), yuv_of(rgbb),
                            min(args.depth, 9), device=dev),
        min(args.depth, 9), _psnr_y255,
        "Y-PSNR vs 255 peak (encode_ply.py:151-152)",
    ))

    sections = []
    for name, steps, frame, depth, psnr_fn, metric_note in workloads:
        def factory(**kw):
            return AttributeCodec(depth, device=dev, **kw)

        mid = _sweep({}, frame, steps, factory, psnr_fn)
        dz = _sweep(dz_kw, frame, steps, factory, psnr_fn)
        bd = bd_rate([r for r, _ in mid], [p for _, p in mid],
                     [r for r, _ in dz], [p for _, p in dz])
        sections += [
            f"## {name}",
            "",
            f"Distortion metric: {metric_note}.",
            "",
            "| step | mid bpp | mid PSNR | dz bpp | dz PSNR |",
            "|---|---|---|---|---|",
            *(
                f"| {s:g} | {m[0]:.4f} | {m[1]:.2f} | {d[0]:.4f} "
                f"| {d[1]:.2f} |"
                for s, m, d in zip(steps, mid, dz)
            ),
            "",
            f"**BD-rate (deadzone vs mid): {bd:+.2f}%**",
            "",
        ]
        print(f"{name}: BD-rate {bd:+.2f}%")

    report = "\n".join([
        "# Dead-zone quantization: measured RD gain (PyTorch port)",
        "",
        f"Synthetic realistic workloads (eval/synth.py), N={args.n}, "
        f"J={args.depth}, seed={args.seed}. Dead-zone parameters: "
        f"f={args.f:.4f} (encoder rounding offset), "
        f"delta={args.delta:.4f} (reconstruction offset). 'mid' is the "
        "reference quantizer (`floor(x/step + 0.5)`); BD-rate < 0 means "
        "the dead-zone path reaches the same PSNR with that much less "
        "rate on average (Bjontegaard cubic-fit method).",
        "",
        run_line("torch_rd_deadzone.py", dev, t0),
        "",
        *sections,
    ])
    return finish_report(args, report)


if __name__ == "__main__":
    raise SystemExit(main())
