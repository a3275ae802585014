"""The port's four RD parity tools against the JAX package's own calls, on
the CPU, at small configurations; and ``scripts/torch_rd_against.py``, the
one comparison every port RD tool's ``--against`` uses.

- colour (``torch_rd_parity_check.py``, n = 2000 at J = 8) and 3DGS
  (``torch_rd_parity_3dgs.py``, n = 1500 at J = 8), steps {1, 8, 64}: the
  tool's frame is the JAX tool's frame, the tool's table prints the JAX
  package's bpp and PSNR, the port leg's streams equal the JAX leg's byte
  for byte and its PSNR is within 1e-9 dB (float64);
- the J=18 tool at depth 12 from base depth 6 and the 3DGS full-grid tool
  at n = 1500, J = 8, each through the port CLI as subprocesses: each
  leg's CSV rows and streams equal the same leg's of the JAX CLI on the
  same file byte for byte (the parity leg, ``golden``, and the default
  one, ``span``), and the table's span Δbpp is the JAX legs' difference;
- a ``--reference`` that names a missing tree exits nonzero (the JAX tools
  skip and return 0);
- ``torch_rd_against.py`` passes an equal table and fails a doctored one.
"""

import csv
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
STEPS = [1.0, 8.0, 64.0]
PSNR_TOL = 1e-9


def _tool(name: str):
    """A port script, imported by path as its siblings import it."""
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # as an import would (dataclasses look it up)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table_rows(path):
    against = _tool("torch_rd_against")
    with open(path) as f:
        return against.read_tables(f.read())[0].rows


def test_colour_parity_leg_matches_jax(tmp_path):
    import jax.numpy as jnp
    from raht3dgs_tpu.models.color_codec import encode_color_frame as jax_encode
    from raht3dgs_tpu.ops.morton import morton_decode
    from raht3dgs_tpu.ops.prelude import morton_codes_np
    from raht3dgs_tpu_torch.models.color_codec import encode_color_frame

    tool = _tool("torch_rd_parity_check")
    n, depth = 2000, 8
    # the JAX tool's frame (rd_parity_check.py:57-68)
    rng = np.random.default_rng(0)
    pts = rng.integers(0, 2**depth, size=(2 * n, 3))
    codes = np.unique(morton_codes_np(pts, depth))[:n]
    V = np.asarray(morton_decode(jnp.asarray(codes), depth), dtype=np.float64)
    rgb = (V / 2**depth * 255.0 + rng.normal(0, 8, size=(len(V), 3))).clip(0, 255)
    tV, trgb = tool.synthetic_frame(n, depth, 0)
    assert np.array_equal(V, tV) and np.array_equal(rgb, trgb)

    ours = jax_encode(V, rgb, depth=depth, steps=STEPS, bucket=1 << 12, keep_streams=True)
    port = encode_color_frame(tV, trgb, depth=depth, steps=STEPS, bucket=1 << 12,
                              keep_streams=True, device="cpu")
    for j, t in zip(ours, port):
        assert t.encoded.stream.to_bytes() == j.encoded.stream.to_bytes()
        assert t.bpp == j.bpp and abs(t.psnr - j.psnr) <= PSNR_TOL
    out = tmp_path / "rd_parity.md"
    assert tool.main(["--n", str(n), "--depth", str(depth), "--steps", *map(str, STEPS),
                      "--device", "cpu", "--out", str(out)]) == 0
    rows = _table_rows(out)
    assert [r[2] for r in rows] == [f"{j.bpp:.6f}" for j in ours]
    assert [r[5] for r in rows] == [f"{j.psnr:.4f}" for j in ours]
    assert {r[c] for r in rows for c in (1, 3, 4, 6)} == {"not run"}


def test_3dgs_parity_leg_matches_jax(tmp_path):
    from raht3dgs_tpu.eval.synth import synthetic_gs_frame as jax_frame
    from raht3dgs_tpu.models.gs_codec import encode_gs_frame as jax_encode
    from raht3dgs_tpu_torch.eval.synth import synthetic_gs_frame
    from raht3dgs_tpu_torch.models.gs_codec import encode_gs_frame

    tool = _tool("torch_rd_parity_3dgs")
    n, depth = 1500, 8
    V, attrs = jax_frame(n, depth, 0)
    tV, tattrs = synthetic_gs_frame(n, depth, 0)
    assert np.array_equal(V, tV) and np.array_equal(attrs, tattrs)
    ours = jax_encode(V.astype(np.int64), attrs, depth=depth, steps=STEPS,
                      bucket=1 << 12, keep_streams=True)
    port = encode_gs_frame(tV.astype(np.int64), tattrs, depth=depth, steps=STEPS,
                           bucket=1 << 12, keep_streams=True, device="cpu")
    for j, t in zip(ours, port):
        assert t.encoded.stream.to_bytes() == j.encoded.stream.to_bytes()
        assert t.bpp == j.bpp
        assert abs(t.psnr["psnr_all"] - j.psnr["psnr_all"]) <= PSNR_TOL
    out = tmp_path / "rd_parity_3dgs.md"
    assert tool.main(["--n", str(n), "--depth", str(depth), "--steps", *map(str, STEPS),
                      "--device", "cpu", "--out", str(out)]) == 0
    rows = _table_rows(out)
    assert [r[2] for r in rows] == [f"{j.bpp:.6f}" for j in ours]
    assert [r[5] for r in rows] == [f"{j.psnr['psnr_all']:.4f}" for j in ours]


def _csv_rows(path, cols):
    with open(path) as f:
        return [tuple(r[c] for c in cols) for r in csv.DictReader(f)]


def _jax_leg(monkeypatch, module, argv, workdir, stream_name, leg):
    """One leg of the JAX CLI on the same file, in process: the parity leg
    (``RAHT3DGS_RAHT_IMPL=golden``) or the default one (``span``), as the
    JAX tool runs them. Returns (csv path, {step: stream bytes})."""
    import importlib

    cli = importlib.import_module(module)
    monkeypatch.setenv("RAHT3DGS_COMPILE_CACHE", "")
    monkeypatch.setenv("RAHT3DGS_RAHT_IMPL", leg)
    csvp, sdir = str(workdir / f"jax_{leg}.csv"), str(workdir / f"jax_{leg}")
    cli.main([*argv, "--platform", "cpu", "--steps", *[f"{s:g}" for s in STEPS],
              "--csv", csvp, "--save-streams", sdir])
    return csvp, {s: open(os.path.join(sdir, stream_name(s)), "rb").read() for s in STEPS}


def _apart_only_at_ties(ply, step, port_bytes, jax_bytes):
    """The symbols in which two default-leg colour streams of ``ply``
    differ, asserting each differs by one and sits where the JAX package's
    parity-leg (golden) coefficient / step lies within 1e-9 of a rounding
    tie."""
    import jax.numpy as jnp
    from raht3dgs_tpu.io.ply import read_ply_8i
    from raht3dgs_tpu.models import pipeline as jp
    from raht3dgs_tpu.ops.color import rgb_to_yuv_parity
    from raht3dgs_tpu_torch.codec.bitstream import FrameStream
    from raht3dgs_tpu_torch.codec.rlgr import rlgr_decode_channels

    V, C, depth = read_ply_8i(str(ply))
    codec = jp.AttributeCodec(depth, dtype=jnp.float64, impl="golden")
    frame = jp.prepare_voxel_frame(np.floor(V).astype(np.int64),
                                   rgb_to_yuv_parity(np.asarray(C)), depth,
                                   dtype=jnp.float64)
    coeffs, order, _, _ = codec.transform(frame)
    n = frame.n_voxels
    perm = np.asarray(jp._pads_last(order, jnp.int32(n)))[:n]
    t = np.asarray(coeffs, np.float64)[perm] / step + 0.5
    ties = (np.abs(t - np.round(t)) <= 1e-9 * np.maximum(1.0, np.abs(t))).T
    syms = []
    for blob in (port_bytes, jax_bytes):
        fs = FrameStream.from_bytes(blob)
        out = np.zeros((fs.n_channels, n), np.int32)
        rlgr_decode_channels(fs.channels, n, out=out, chunk=fs.chunk)
        syms.append(out)
    diff = syms[0] != syms[1]
    assert not (diff & ~ties).any(), f"{int((diff & ~ties).sum())} symbols apart off a tie"
    assert np.abs(syms[0] - syms[1])[diff].max() == 1
    return int(diff.sum())


@pytest.mark.parametrize("tool_name, module, extra, stream_name, psnr_col, ply", [
    ("torch_rd_parity_j18", "raht3dgs_tpu.cli.encode_ply",
     ["--depth", "12", "--base-depth", "6"], lambda s: f"frame0001_step{s:g}.r3tc", "psnr",
     "scan_j12.ply"),
    ("torch_rd_parity_3dgs_full", "raht3dgs_tpu.cli.encode_3dgs",
     ["--n", "1500", "--depth", "8"], lambda s: f"gs_step{s:g}.r3tc", "PSNR_all",
     "gs_j8.ply"),
], ids=["j18", "3dgs_full"])
def test_cli_parity_legs_match_jax_clis(tmp_path, monkeypatch, tool_name, module, extra,
                                        stream_name, psnr_col, ply):
    tool = _tool(tool_name)
    work = tmp_path / "work"
    keep = "--keep-ply" if tool_name.endswith("j18") else "--keep"
    assert tool.main([*extra, "--steps", *[f"{s:g}" for s in STEPS], "--device", "cpu",
                      keep, str(work), "--csv", str(tmp_path / "port.csv"),
                      "--out", str(tmp_path / "port.md")]) == 0
    jargv = ["--input", str(work / ply)]
    if tool_name.endswith("3dgs_full"):
        jargv += ["--depth", "8"]
    cols = ("Quantization_Step", "Rate_bpp", psnr_col)
    port_csv = {"golden": tmp_path / "port.csv", "span": tmp_path / "port_span.csv"}
    jrows, trows = {}, {}
    # each port leg against the same leg of the JAX CLI on the same file:
    # the parity legs byte for byte; the default (span) legs too, except
    # that integer colours put some coefficients on quantization ties, which
    # the two packages' float association may round apart (the gate of
    # ROADMAP item 6), so there the differing symbols must all sit on a tie
    for leg in ("golden", "span"):
        jcsv, jstreams = _jax_leg(monkeypatch, module, jargv, tmp_path, stream_name, leg)
        jrows[leg], trows[leg] = _csv_rows(jcsv, cols), _csv_rows(port_csv[leg], cols)
        assert [r[0] for r in trows[leg]] == [r[0] for r in jrows[leg]], leg
        for s, a, b in zip(STEPS, trows[leg], jrows[leg]):
            port_bytes = open(work / f"streams_{leg}" / stream_name(s), "rb").read()
            if leg == "span" and port_bytes != jstreams[s] and tool_name.endswith("j18"):
                assert _apart_only_at_ties(work / ply, s, port_bytes, jstreams[s]) > 0
                continue
            assert port_bytes == jstreams[s], (leg, s)
            assert a[1] == b[1] and abs(float(a[2]) - float(b[2])) <= PSNR_TOL, (leg, s)
    rows = _table_rows(tmp_path / "port.md")
    assert [r[2] for r in rows] == [f"{float(r[1]):.6f}" for r in jrows["golden"]]
    assert [r[5] for r in rows] == [f"{float(r[2]):.4f}" for r in jrows["golden"]]
    # span Δbpp: the port's span leg's rate against its parity leg's
    assert [r[8] for r in rows] == [
        f"{abs(float(s[1]) - float(g[1])):.2e}"
        for s, g in zip(trows["span"], trows["golden"])]
    # the span leg ran too, and the tool compared its streams with the parity leg's
    span = _tool("torch_rd_against").read_tables((tmp_path / "port.md").read_text())[1]
    assert [r[0] for r in span.rows] == [f"{s:g}" for s in STEPS]
    assert all(r[3] in ("yes", "NO") and int(r[4]) >= 0 for r in span.rows)
    if tool_name.endswith("j18"):
        # every symbol the span leg rounds apart from the parity leg is on a tie
        assert any(r[3] == "NO" for r in span.rows)
        assert all(r[5] == r[4] for r in span.rows if r[3] == "NO")


@pytest.mark.parametrize("tool_name", ["torch_rd_parity_check", "torch_rd_parity_3dgs",
                                       "torch_rd_parity_j18", "torch_rd_parity_3dgs_full"])
def test_missing_reference_exits_nonzero(tmp_path, tool_name):
    tool = _tool(tool_name)
    with pytest.raises(SystemExit) as e:
        tool.main(["--device", "cpu", "--reference", str(tmp_path / "missing")])
    assert e.value.code not in (0, None)


def test_j18_span_check_reads_the_doc(tmp_path):
    """The J=18 tool holds the two legs' streams equal at the steps where
    the JAX document's span Δbpp is 0."""
    tool = _tool("torch_rd_parity_j18")
    zero = tool.span_zero_steps(os.path.join(REPO, "docs", "rd_parity_j18.md"))
    assert zero == {24.0, 32.0, 64.0}
    full = tool.span_zero_steps(os.path.join(REPO, "docs", "rd_parity_3dgs_full.md"))
    assert full == {1.0, 4.0, 8.0, 12.0, 16.0, 20.0, 24.0, 32.0, 64.0}


# -- torch_rd_against.py ----------------------------------------------------------

def _doc(name):
    with open(os.path.join(REPO, "docs", name)) as f:
        return f.read()


@pytest.mark.parametrize("doc", ["rd_parity.md", "rd_parity_3dgs.md", "rd_parity_j18.md",
                                 "rd_parity_3dgs_full.md", "rd_deadzone.md", "rd_attr_entropy.md",
                                 "rd_predict.md", "rd_temporal.md", "rd_ratecontrol.md",
                                 "rd_tiling.md"])
def test_against_passes_an_equal_document(doc):
    against = _tool("torch_rd_against")
    text = _doc(doc)
    ok, report = against.compare(text, text)
    assert ok, report
    assert report[-1] == "VERDICT: equal"


def _doctor(text, old, new):
    assert old in text
    return text.replace(old, new, 1)


@pytest.mark.parametrize("doc, old, new, ok, psnr_tol", [
    ("rd_parity.md", "| 8 | 6.955733 | 6.955733 |", "| 8 | 6.955733 | 6.955734 |", False, 0.0),
    ("rd_parity.md", "| 40.8520 | 40.8520 |", "| 40.8520 | 40.8521 |", False, 0.0),
    ("rd_parity.md", "| 40.8520 | 40.8520 |", "| 40.8520 | 40.8521 |", True, 1e-4),
    ("rd_parity.md", "| 40.8520 | 40.8520 |", "| 40.8520 | 40.8522 |", False, 1e-4),
    ("rd_parity.md", "| 64 | 0.359733 |", "| 65 | 0.359733 |", False, 0.0),
    ("rd_deadzone.md", "**BD-rate (deadzone vs mid): -13.03%**",
     "**BD-rate (deadzone vs mid): -13.04%**", False, 0.0),
    ("rd_attr_entropy.md", "| 4 | 46.90 | 9.1488 | 8.1163 | -11.3% | 3/3 |",
     "| 4 | 46.90 | 9.1488 | 8.1163 | -11.3% | 2/3 |", False, 0.0),
    ("rd_predict.md", "| plain | 5.14 | 2.48 | 7.55 | 0.20 |",
     "| plain | 9.99 | 1.11 | 0.55 | 7.77 |", True, 0.0),          # times: skipped
    ("rd_predict.md", "| plain | 5.14 | 2.48 | 7.55 | 0.20 |",
     "| plainer | 5.14 | 2.48 | 7.55 | 0.20 |", False, 0.0),
    ("rd_ratecontrol.md", "| IIIII |", "| IPIII |", False, 0.0),
    ("rd_tiling.md", "| 2 | 8 | 1.7501 |", "| 2 | 8 | 1.7502 |", False, 0.0),
])
def test_against_doctored_port_output(doc, old, new, ok, psnr_tol):
    against = _tool("torch_rd_against")
    text = _doc(doc)
    got, report = against.compare(text, _doctor(text, old, new), psnr_tol=psnr_tol)
    assert got is ok, report


def test_against_names_skipped_and_unpaired(tmp_path):
    """Time columns and ``not run`` columns are named; a doc table with no
    port counterpart is named; a port output with a row missing, or with no
    table the doc has, fails."""
    against = _tool("torch_rd_against")
    doc = _doc("rd_predict.md")
    # the port prints no device-walls table (the doc's hand-written one)
    start = doc.index("| leg | first step s")
    port = doc[:start] + doc[doc.index("\n\n", start):]
    ok, report = against.compare(doc, port)
    assert ok, report
    text = "\n".join(report)
    assert "`sweep encode s`" in text and "`enc Mpts/s (warm)`" in text
    assert "doc table without a port counterpart" in text  # the device-walls table
    par = _doc("rd_parity.md")
    port = par.replace("| 15.569600 | 15.569600 |", "| not run | 15.569600 |")
    lines = [ln if not ln.startswith("| ") or ln.startswith("| step") else
             "| " + " | ".join(c if i not in (1, 3, 4, 6) else "not run"
                               for i, c in enumerate(ln.strip().strip("|").split(" | "))) + " |"
             for ln in port.splitlines()]
    ok, report = against.compare(par, "\n".join(lines))
    assert ok, report
    assert any("printed `not run`" in r for r in report)
    short = "\n".join(ln for ln in par.splitlines() if not ln.startswith("| 64 "))
    assert not against.compare(par, short)[0]
    assert not against.compare(par, "# nothing here\n")[0]
    # the command line: exit 0 / 1
    good, bad = tmp_path / "good.md", tmp_path / "bad.md"
    good.write_text(par)
    bad.write_text(_doctor(par, "| 2 | 12.844533 | 12.844533 |", "| 2 | 12.844533 | 12.8 |"))
    doc_path = os.path.join(REPO, "docs", "rd_parity.md")
    assert against.main([doc_path, str(good)]) == 0
    assert against.main([doc_path, str(bad)]) == 1
