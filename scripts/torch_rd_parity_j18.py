#!/usr/bin/env python3
"""Full-grid RD parity of the PyTorch port at the reference's canonical
colour operating point: J=18, the 11-step grid {1,2,4,6,8,12,16,20,24,32,64}.

The port's counterpart of ``scripts/rd_parity_j18.py``:

- writes the JAX tool's frame (``build_frame``: the depth-10 articulated
  body scan of ``eval/synth.py`` lifted to the 2^18 grid by seeded
  sub-voxel jitter, about 1 M voxels) as an ASCII PLY on disk;
- runs both port legs as real subprocesses of ``python -m
  raht3dgs_tpu_torch.cli.encode_ply`` on that file (CSV plus ``.r3tc``
  streams, float64, the CLI's defaults): the parity leg
  (``RAHT3DGS_RAHT_IMPL=golden``, the host ragged transform with the
  reference's sqrt) and the span leg (the default device path), each
  timed; the CSV goes through ``scripts/summarize_pipeline_runtime.py``;
- reads each leg's CSV and byte-compares the three channel payloads of
  the two legs' streams step by step, counting the symbols that differ
  (quantization ties, which the span path's other float association
  rounds the other way);
- with ``--reference PATH``, runs the upstream reference's PyTorch
  pipeline on the same file with the port's RLGR coder and compares rates,
  Y-PSNR and stream bytes (a PATH that does not exist is an error, never a
  skip); without it the reference columns read ``not run``;
- without ``--reference``, the span Δbpp column is the span leg's rate
  against the parity leg's (the JAX document shows the parity leg
  byte-equal to the reference, so the parity leg's printed rate is the
  reference's); span ΔPSNR, against the reference's unrounded PSNR,
  reads ``not run``;
- with ``--against docs/rd_parity_j18.md``, holds the parity leg's bpp and
  Y-PSNR and the span Δbpp against the JAX document
  (``scripts/torch_rd_against.py``) and requires the two legs' streams to
  be equal at every step where the document's span Δbpp is 0.

    python scripts/torch_rd_parity_j18.py [--device cuda|cpu] \
        [--out F] [--against docs/rd_parity_j18.md] [--keep-ply DIR]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_rd_deadzone import add_port_args, finish_report, run_line  # noqa: E402
from torch_rd_against import NOT_RUN  # noqa: E402
from torch_rd_parity_check import check_reference  # noqa: E402


def build_frame(depth, seed, base_depth=10):
    """Unique Morton-ordered voxels on the 2^depth grid with scan-like
    colour statistics: the base-depth articulated body scan lifted to depth
    by deterministic sub-voxel jitter (children of unique parents are
    unique). The JAX tool's ``build_frame``, the same rng calls."""
    import numpy as np

    from raht3dgs_tpu_torch.eval.synth import synthetic_body_scan
    from raht3dgs_tpu_torch.ops.prelude import morton_codes_np

    (V10, rgb) = synthetic_body_scan(
        depth=base_depth, seed=seed, n_frames=1, samples_per_voxel=2.0
    )[0]
    rng = np.random.default_rng(seed + 1)
    lift = depth - base_depth
    V = V10.astype(np.int64) * (1 << lift) + rng.integers(
        0, 1 << lift, size=V10.shape
    )
    rgb = np.clip(np.round(rgb), 0, 255).astype(np.int64)
    codes = morton_codes_np(V, depth)
    assert np.unique(codes).size == codes.size, "lifted voxels not unique"
    order = np.argsort(codes, kind="stable")
    return V[order], rgb[order]


def read_csv(path, psnr_col):
    """(step, bpp, psnr) per row of a port CLI's CSV."""
    rows = []
    with open(path) as f:
        header = f.readline().strip().split(",")
        bpp_i = header.index("Rate_bpp")
        step_i = header.index("Quantization_Step")
        psnr_i = header.index(psnr_col)
        for line in f:
            cells = line.strip().split(",")
            rows.append((float(cells[step_i]), float(cells[bpp_i]),
                         float(cells[psnr_i])))
    return rows


def run_legs(module, extra, dev, workdir, csv_path, steps):
    """Both port legs through ``python -m <module>`` subprocesses: {leg:
    (stream dir, csv path, seconds)}."""
    legs = {}
    for leg, csvp in (("golden", csv_path), ("span", csv_path.replace(".csv", "_span.csv"))):
        stream_dir = os.path.join(workdir, f"streams_{leg}")
        env = dict(os.environ, RAHT3DGS_RAHT_IMPL=leg,
                   PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", module, *extra, "--platform", dev.type,
             "--steps", *[f"{s:g}" for s in steps],
             "--csv", csvp, "--save-streams", stream_dir],
            cwd=REPO, env=env, check=True,
        )
        legs[leg] = (stream_dir, csvp, time.perf_counter() - t0)
        print(f"CLI {leg} leg done in {legs[leg][2]:.1f}s -> {csvp}")
    return legs


def stream_diff(a, b, ties=None):
    """(equal, symbols that differ, of them on a tie) between two frame
    streams' channels; ``ties`` is a (D, n) mask of the positions on a
    quantization tie, or None (the last count is then None)."""
    import numpy as np

    from raht3dgs_tpu_torch.codec.rlgr import rlgr_decode_channels

    if a.n_channels == b.n_channels and all(x == y for x, y in zip(a.channels, b.channels)):
        return True, 0, 0
    n = a.n_voxels
    va, _ = rlgr_decode_channels(a.channels, n, chunk=a.chunk)
    vb, _ = rlgr_decode_channels(b.channels, b.n_voxels, chunk=b.chunk)
    diff = va[:, :n] != vb[:, : b.n_voxels]
    return False, int(diff.sum()), None if ties is None else int((diff & ties).sum())


def colour_tie_masks(ply_path, dev):
    """step -> (3, n) mask of the stream positions whose parity-leg
    coefficient / step lies within 1e-9 of a rounding tie (the gate of
    ROADMAP item 6): the golden colour transform of the PLY, as the
    parity leg computes it, run once. The span leg's own coefficients
    carry its prefix differences' absolute error (~1e-8 at J=18), so
    they may sit just off a tie that the golden ones sit on."""
    import numpy as np
    import torch

    from raht3dgs_tpu_torch.io.ply import read_ply_8i
    from raht3dgs_tpu_torch.models.pipeline import (
        AttributeCodec,
        _pads_last,
        prepare_voxel_frame,
    )
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv_parity

    V, C, depth = read_ply_8i(ply_path)
    codec = AttributeCodec(depth, dtype=torch.float64, device=dev, impl="golden")
    frame = prepare_voxel_frame(np.floor(V).astype(np.int64), rgb_to_yuv_parity(C), depth,
                                dtype=torch.float64, device=dev)
    coeffs, order, _, _ = codec.transform(frame)
    n = frame.n_voxels
    order = torch.as_tensor(order)
    c = torch.as_tensor(coeffs)[_pads_last(order, n)[:n].to(order.device)]
    c = c.double().cpu().numpy().T

    def mask(step):
        t = c / step + 0.5
        return np.abs(t - np.round(t)) <= 1e-9 * np.maximum(1.0, np.abs(t))

    return mask


def span_zero_steps(doc_path):
    """The steps at which the JAX document's span Δbpp is 0."""
    from torch_rd_against import read_tables

    with open(doc_path) as f:
        t = next(t for t in read_tables(f.read()) if "span Δbpp" in t.header)
    c = t.header.index("span Δbpp")
    return {float(r[0]) for r in t.rows if float(r[c]) == 0.0}


def reference_leg(ply_path, depth, steps, reference):
    """The upstream reference's pipeline at J=depth on the same file, with
    the port's RLGR coder: ([(bpp, psnr, [channel bytes x3])], N)."""
    sys.path.insert(0, reference)
    import numpy as np
    import torch
    from RAHT import RAHT2_optimized
    from RAHT_param import RAHT_param_reorder_fast
    from data_util import read_ply_file
    from utils import rgb_to_yuv as ref_rgb_to_yuv

    from raht3dgs_tpu_torch.codec.rlgr import rlgr_encode

    V, Crgb = read_ply_file(ply_path)
    N = V.shape[0]
    C = ref_rgb_to_yuv(Crgb.to(torch.float64))
    Lists, Flags, weights, order = RAHT_param_reorder_fast(
        V.to(torch.float64), torch.zeros(3, dtype=torch.float64), 2**depth, depth)
    Coeff, _ = RAHT2_optimized(C, Lists, Flags, weights)
    rows = []
    for step in steps:
        q = torch.floor(Coeff / step + 0.5)
        mse = float(torch.linalg.norm(Coeff[:, 0] - q[:, 0] * step) ** 2) / (N * 255.0**2)
        reordered = q.index_select(0, order).to(torch.int64).numpy()
        chans = [rlgr_encode(reordered[:, d])[0] for d in range(3)]
        rows.append((sum(len(c) for c in chans) * 8.0 / N, -10.0 * np.log10(mse), chans))
    return rows, N


def parity_rows(steps, legs, stream_name, psnr_col, ref_rows, ties=None):
    """The document's table rows and the port-only table of the span leg;
    (rows, span rows, summary dict). ``ties`` (a callable giving step -> tie
    mask, called at the first step whose legs differ) counts the differing
    symbols on a tie."""
    from raht3dgs_tpu_torch.codec.bitstream import FrameStream

    ours = read_csv(legs["golden"][1], psnr_col)
    span = read_csv(legs["span"][1], psnr_col)
    assert [s for s, _, _ in ours] == [float(s) for s in steps]
    rows, span_rows, tie_fn = [], [], None
    summ = {"worst_bpp": 0.0, "worst_psnr": 0.0, "span_worst_bpp": 0.0,
            "span_worst_psnr": 0.0, "identical": True, "span_equal": {}}
    for i, ((step, o_bpp, o_psnr), (_, s_bpp, s_psnr)) in enumerate(zip(ours, span)):
        fs = [FrameStream.from_bytes(open(os.path.join(legs[leg][0], stream_name(step)),
                                          "rb").read()) for leg in ("golden", "span")]
        mask = None
        if ties is not None and list(fs[0].channels) != list(fs[1].channels):
            tie_fn = tie_fn or ties()
            mask = tie_fn(step)
        equal, n_diff, n_tie = stream_diff(*fs, mask)
        summ["span_equal"][step] = equal
        span_rows.append(f"| {step:g} | {s_bpp:.6f} | {s_psnr:.4f} | "
                         f"{'yes' if equal else 'NO'} | {n_diff} "
                         f"| {'not counted' if n_tie is None else n_tie} |")
        if ref_rows is None:
            # the documents show the parity leg byte-equal to the reference,
            # so its CSV rate stands for the reference's rounded one; span
            # ΔPSNR needs the reference's unrounded PSNR and waits for it
            sd_bpp = abs(s_bpp - o_bpp)
            summ["span_worst_bpp"] = max(summ["span_worst_bpp"], sd_bpp)
            rows.append(f"| {step:g} | {NOT_RUN} | {o_bpp:.6f} | {NOT_RUN} | {NOT_RUN} "
                        f"| {o_psnr:.4f} | {NOT_RUN} | {NOT_RUN} | {sd_bpp:.2e} | {NOT_RUN} |")
            continue
        r_bpp, r_psnr, r_chans = ref_rows[i]
        same = len(fs[0].channels) == len(r_chans) and all(
            a == b for a, b in zip(fs[0].channels, r_chans))
        summ["identical"] &= same
        # the CSV prints bpp at 6 decimals: compare with the reference's
        # rate rounded the same way (stream identity is the exact oracle)
        d_bpp, d_psnr = abs(o_bpp - float(f"{r_bpp:.6f}")), abs(o_psnr - r_psnr)
        sd_bpp, sd_psnr = abs(s_bpp - float(f"{r_bpp:.6f}")), abs(s_psnr - r_psnr)
        summ["worst_bpp"] = max(summ["worst_bpp"], d_bpp)
        summ["worst_psnr"] = max(summ["worst_psnr"], d_psnr)
        summ["span_worst_bpp"] = max(summ["span_worst_bpp"], sd_bpp)
        summ["span_worst_psnr"] = max(summ["span_worst_psnr"], sd_psnr)
        rows.append(f"| {step:g} | {r_bpp:.6f} | {o_bpp:.6f} | {d_bpp:.2e} "
                    f"| {r_psnr:.4f} | {o_psnr:.4f} | {d_psnr:.2e} "
                    f"| {'yes' if same else 'NO'} | {sd_bpp:.2e} | {sd_psnr:.2e} |")
    return rows, span_rows, summ


SPAN_TABLE = ["| step | span bpp | span PSNR | span streams == parity leg's "
              "| symbols that differ | of them on a tie |", "|---|---|---|---|---|---|"]


def span_verdict(args, summ):
    """With ``--against``: the steps where the document's span Δbpp is 0 and
    the two port legs' streams differ (must be none)."""
    if not args.against:
        return []
    zero = span_zero_steps(args.against)
    return sorted(s for s, eq in summ["span_equal"].items() if s in zero and not eq)


def verdict_lines(args, reference, summ, span_bad):
    """The report's closing lines: the reference leg's summary when it ran,
    the span check against the document's span Δbpp under ``--against``."""
    out = []
    if reference:
        out += [f"**Parity leg: max |Δbpp| = {summ['worst_bpp']:.3e}, max |ΔPSNR| = "
                f"{summ['worst_psnr']:.3e} dB, all streams byte-identical: "
                f"{summ['identical']}.** Span leg: max |Δbpp| = "
                f"{summ['span_worst_bpp']:.3e}, max |ΔPSNR| = "
                f"{summ['span_worst_psnr']:.3e} dB.", ""]
    else:
        out += ["Span leg against the parity leg: max |Δbpp| = "
                f"{summ['span_worst_bpp']:.3e}.", ""]
    if args.against:
        out += ["Span streams equal the parity leg's at every step where the "
                f"document's span Δbpp is 0: {not span_bad}"
                + (f" (they differ at steps {', '.join(f'{s:g}' for s in span_bad)})"
                   if span_bad else "") + ".", ""]
    return out


def parity_ok(reference, summ, span_bad, psnr_limit):
    """The JAX tool's pass rule on the reference leg (when it ran) and the
    span check."""
    return (reference is None or (summ["worst_bpp"] == 0.0 and summ["identical"]
                                  and summ["worst_psnr"] < psnr_limit)) and not span_bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--depth", type=int, default=18)
    ap.add_argument("--base-depth", type=int, default=10,
                    help="body-scan voxelization depth before the lift "
                    "(10 -> ~1 M voxels; lower for smoke tests)")
    ap.add_argument("--steps", type=float, nargs="+",
                    default=[1, 2, 4, 6, 8, 12, 16, 20, 24, 32, 64])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reference", default=None,
                    help="the upstream reference's python tree; its leg runs "
                    "only when given, and a missing tree is an error")
    ap.add_argument("--csv", default="results/port/runtime_ply_j18.csv")
    ap.add_argument("--out", default=None)
    ap.add_argument("--keep-ply", default=None,
                    help="directory to keep the generated PLY + streams "
                    "(default: a temp dir, deleted afterwards)")
    add_port_args(ap)
    args = ap.parse_args(argv)
    reference = check_reference(args.reference)

    t0 = time.perf_counter()
    from raht3dgs_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)

    import numpy as np

    from raht3dgs_tpu_torch.io.ply import save_ply_ascii

    workdir = args.keep_ply or tempfile.mkdtemp(prefix="torch_rd_parity_j18_")
    os.makedirs(workdir, exist_ok=True)
    ply_path = os.path.join(workdir, f"scan_j{args.depth}.ply")
    V, rgb = build_frame(args.depth, args.seed, args.base_depth)
    save_ply_ascii(ply_path, V.astype(np.float64), rgb, width=2**args.depth - 1)
    print(f"wrote {ply_path}: {len(V)} voxels on the 2^{args.depth} grid")

    csv_path = os.path.join(REPO, args.csv)
    os.makedirs(os.path.dirname(csv_path), exist_ok=True)
    legs = run_legs("raht3dgs_tpu_torch.cli.encode_ply", ["--input", ply_path], dev,
                    workdir, csv_path, args.steps)
    summary_md = csv_path.replace(".csv", "_summary.md")
    subprocess.run([sys.executable, "scripts/summarize_pipeline_runtime.py",
                    "--raht-log", csv_path, "--out", summary_md],
                   cwd=REPO, check=True, stdout=subprocess.DEVNULL)
    print(f"reporting script consumed the CSV -> {summary_md}")

    ref_rows, n = (reference_leg(ply_path, args.depth, args.steps, reference)
                   if reference else (None, len(V)))
    rows, span_rows, summ = parity_rows(
        args.steps, legs, lambda s: f"frame0001_step{s:g}.r3tc", "psnr", ref_rows,
        ties=lambda: colour_tie_masks(ply_path, dev))
    span_bad = span_verdict(args, summ)

    report = "\n".join([
        "# RD parity at the reference's J=18 operating point (PyTorch port)",
        "",
        f"Config: **J={args.depth}, steps "
        f"{{{', '.join(f'{s:g}' for s in args.steps)}}}, N={n} voxels** — "
        "the reference's canonical color configuration. Content: scan-like "
        "articulated body (eval/synth.py, base depth "
        f"{args.base_depth}) lifted to the 2^{args.depth} grid, written to "
        "disk as ASCII PLY and consumed from the file.",
        "",
        "Both port legs ran end-to-end through `python -m "
        f"raht3dgs_tpu_torch.cli.encode_ply --platform {dev.type}` as real "
        "subprocesses (PLY in, CSV + `.r3tc` bitstreams out, float64; the "
        "CSV is consumed unchanged by `scripts/summarize_pipeline_runtime.py`): "
        "the **parity leg** (`RAHT3DGS_RAHT_IMPL=golden`, "
        f"{legs['golden'][2]:.1f} s) and the **span leg** (the default device "
        f"path, {legs['span'][2]:.1f} s). Reference leg: "
        + ("the upstream reference's PyTorch pipeline imported from "
           f"`{reference}` with the port's RLGR coder." if reference else
           "not run (no `--reference`; it waits for the upstream reference "
           "tree)."),
        "",
        run_line("torch_rd_parity_j18.py", dev, t0),
        "",
        "| step | ref bpp | ours bpp | Δbpp | ref Y-PSNR | ours Y-PSNR "
        "| ΔPSNR | streams == | span Δbpp | span ΔPSNR |",
        "|---|---|---|---|---|---|---|---|---|---|",
        *rows,
        "",
        "The span leg against the parity leg ('symbols that differ' counts "
        "the decoded symbols of all three channels that are not equal; 'on "
        "a tie' those whose parity-leg coefficient / step lies within 1e-9 "
        "of a rounding tie, the gate of ROADMAP item 6):",
        "",
        *SPAN_TABLE,
        *span_rows,
        "",
        *verdict_lines(args, reference, summ, span_bad),
    ])
    print(report)
    ok = parity_ok(reference, summ, span_bad, 1e-6)
    rc = finish_report(args, report)
    if args.keep_ply is None:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return rc if ok else 1


if __name__ == "__main__":
    sys.exit(main())
