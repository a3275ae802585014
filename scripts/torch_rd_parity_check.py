#!/usr/bin/env python3
"""Colour rate-distortion parity of the PyTorch port.

The port's counterpart of ``scripts/rd_parity_check.py``: the same
synthetic frame (the same rng calls, Morton-unique codes, bucket 2^12), run
through the port's colour codec (``encode_color_frame``: RAHT, quantize,
RLGR, decode) at each quantization step, printing the JAX tool's table.

- With ``--reference PATH`` the reference leg runs too: the upstream
  reference's PyTorch pipeline imported from PATH (``RAHT_param_reorder_fast``
  + ``RAHT2_optimized`` + ``inverse_RAHT_optimized``, its ``rgb_to_yuv``)
  with the port's RLGR coder, and the Δ columns compare the two. A PATH
  that does not exist is an error (a nonzero exit), never a skip.
- Without it, the reference columns read ``not run`` and ``--against
  docs/rd_parity.md`` holds the port's columns against the JAX package's
  committed table (``scripts/torch_rd_against.py``).

    python scripts/torch_rd_parity_check.py [--n 50000] [--depth 10] \
        [--steps 1 2 4 8 16 32 64] [--device cuda|cpu] [--reference DIR] \
        [--out F] [--against docs/rd_parity.md]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_rd_against import NOT_RUN  # noqa: E402
from torch_rd_deadzone import add_port_args, finish_report, run_line  # noqa: E402

def synthetic_frame(n: int, depth: int, seed: int):
    """The JAX tool's frame: unique Morton-ordered voxels and smooth-ish
    colours, from the same rng calls (``rd_parity_check.py:57-68``)."""
    import numpy as np

    from raht3dgs_tpu_torch.ops.morton import morton_decode
    from raht3dgs_tpu_torch.ops.prelude import morton_codes_np

    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 2**depth, size=(2 * n, 3))
    codes = np.unique(morton_codes_np(pts, depth))[:n]
    V = morton_decode(codes, depth, device="cpu").numpy().astype(np.float64)
    rgb = (V / 2**depth * 255.0 + rng.normal(0, 8, size=(len(V), 3))).clip(0, 255)
    return V, rgb


def check_reference(path):
    """The reference tree's directory, or an error when it was named and is
    absent (no silent success)."""
    if path is not None and not os.path.isdir(path):
        raise SystemExit(f"error: reference tree not found at {path}")
    return path


def reference_leg(reference, V, rgb, depth, steps):
    """The upstream reference's PyTorch pipeline on the same frame, with the
    port's RLGR coder: [(bpp, Y-PSNR)] per step."""
    sys.path.insert(0, reference)
    import torch
    from RAHT import RAHT2_optimized
    from RAHT_param import RAHT_param_reorder_fast
    from iRAHT import inverse_RAHT_optimized
    from utils import rgb_to_yuv as ref_rgb_to_yuv

    from raht3dgs_tpu_torch.codec.rlgr import rlgr_encode
    from raht3dgs_tpu_torch.models.color_codec import y_psnr_db

    n = len(V)
    Vt = torch.from_numpy(V).to(torch.float64)
    C = ref_rgb_to_yuv(torch.from_numpy(rgb).to(torch.float64))
    Lists, Flags, weights, order = RAHT_param_reorder_fast(
        Vt, torch.zeros(3, dtype=torch.float64), 2**depth, depth)
    Coeff, _ = RAHT2_optimized(C, Lists, Flags, weights)
    out = []
    for step in steps:
        q = torch.floor(Coeff / step + 0.5)
        reordered = q.index_select(0, order).to(torch.int64).numpy()
        nbytes = sum(len(rlgr_encode(reordered[:, d])[0]) for d in range(3))
        rec = inverse_RAHT_optimized(q * step, Lists, Flags, weights)
        out.append((nbytes * 8 / n, y_psnr_db(C[:, 0].numpy(), rec[:, 0].numpy())))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=50000)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--steps", type=float, nargs="+",
                    default=[1, 2, 4, 8, 16, 32, 64])
    ap.add_argument("--reference", default=None,
                    help="the upstream reference's python tree; its leg runs "
                    "only when given, and a missing tree is an error")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    add_port_args(ap)
    args = ap.parse_args(argv)
    reference = check_reference(args.reference)

    t0 = time.perf_counter()
    from raht3dgs_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)

    from raht3dgs_tpu_torch.models.color_codec import encode_color_frame

    V, rgb = synthetic_frame(args.n, args.depth, args.seed)
    n = len(V)
    t1 = time.perf_counter()
    ours = encode_color_frame(V, rgb, depth=args.depth, steps=args.steps,
                              bucket=1 << 12, device=dev)
    port_s = time.perf_counter() - t1
    ref = reference_leg(reference, V, rgb, args.depth, args.steps) if reference else None

    rows = []
    worst_bpp = worst_psnr = 0.0
    for i, step in enumerate(args.steps):
        o = ours[i]
        if ref is None:
            rows.append(f"| {step:g} | {NOT_RUN} | {o.bpp:.6f} | {NOT_RUN} "
                        f"| {NOT_RUN} | {o.psnr:.4f} | {NOT_RUN} |")
            continue
        ref_bpp, ref_psnr = ref[i]
        d_bpp, d_psnr = abs(o.bpp - ref_bpp), abs(o.psnr - ref_psnr)
        worst_bpp, worst_psnr = max(worst_bpp, d_bpp), max(worst_psnr, d_psnr)
        rows.append(f"| {step:g} | {ref_bpp:.6f} | {o.bpp:.6f} | {d_bpp:.2e} "
                    f"| {ref_psnr:.4f} | {o.psnr:.4f} | {d_psnr:.2e} |")

    report = "\n".join([
        "# RD parity vs the reference implementation (PyTorch port)",
        "",
        f"Synthetic Morton-ordered frame: N={n}, J={args.depth}, "
        f"seed={args.seed}. Port leg: `encode_color_frame` on {dev.type} "
        f"(float64, bucket 2^12), {port_s:.2f} s. Reference leg: "
        + (f"PyTorch pipeline imported from `{reference}` (RLGR via the port's "
           "coder)." if ref else "not run (no `--reference`; it waits for the "
           "upstream reference tree)."),
        "",
        run_line("torch_rd_parity_check.py", dev, t0),
        "",
        "| step | ref bpp | ours bpp | Δbpp | ref Y-PSNR | ours Y-PSNR | ΔPSNR |",
        "|---|---|---|---|---|---|---|",
        *rows,
        "",
    ] + ([f"max |Δbpp| = {worst_bpp:.3e}, max |ΔPSNR| = {worst_psnr:.3e} dB", ""]
         if ref else []))
    print(report)
    ok = ref is None or (worst_bpp < 1e-6 and worst_psnr < 1e-3)
    if ref is not None:
        print("PARITY:", "OK" if ok else "FAILED")
    rc = finish_report(args, report)
    return rc if ok else 1


if __name__ == "__main__":
    sys.exit(main())
