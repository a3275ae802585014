"""The rate-targeted CLIs of the port against the JAX package's, in process,
on the same files: ``encode_ply --target-bpp`` (with ``--voxelize``,
``--code-geometry``, ``--predict``), ``encode_3dgs --target-bpp`` (with and
without ``--per-attribute``), and ``encode_dataset`` with ``--target-bpp``,
``--cbr``, ``--cbr-burst``, ``--cbr-gop`` and ``--two-pass``.

At float64 on non-integer attributes both packages' streams are
byte-identical (ROADMAP queue A, item 6's gate): the saved ``.r3tc`` files
are equal, the printed steps and rates are equal, and the CSV rows equal
apart from the time columns, PSNR within 1e-9 dB."""

import re

import numpy as np
import pytest
import torch

from raht3dgs_tpu.cli import encode_3dgs as jgs, encode_dataset as jds, encode_ply as jply
from raht3dgs_tpu_torch.cli import encode_3dgs as tgs, encode_dataset as tds, encode_ply as tply
from raht3dgs_tpu_torch.codec.bitstream import FrameStream
from raht3dgs_tpu_torch.eval.synth import synthetic_gs_frame
from raht3dgs_tpu_torch.io.datasets import frame_path
from raht3dgs_tpu_torch.io.ply import save_ply_3dgs, save_ply_ascii
from raht3dgs_tpu_torch.ops.morton import morton_codes_np
from raht3dgs_tpu_torch.utils import synth

PSNR_TOL = 1e-9
# the printed search wall, which differs run to run
_WALL = re.compile(r", \d+\.\d+s\)$")


@pytest.fixture(autouse=True)
def _quiet_jax_and_one_thread(monkeypatch):
    # the JAX CLIs turn on a persistent compile cache unless this is empty
    monkeypatch.setenv("RAHT3DGS_COMPILE_CACHE", "")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(capsys, cli, argv, out_dir=None):
    """The lines ``cli`` prints, its wall and its output directory masked."""
    capsys.readouterr()
    assert cli.main(argv) == 0
    text = capsys.readouterr().out
    if out_dir is not None:
        text = text.replace(str(out_dir), "<out>")
    return [_WALL.sub(")", ln) for ln in text.splitlines()]


def _csv(path):
    lines = path.read_text().strip().splitlines()
    return lines[0], [ln.split(",") for ln in lines[1:]]


def _same_rows(jcsv, tcsv, n_rows):
    (jh, jrows), (th, trows) = _csv(jcsv), _csv(tcsv)
    assert th == jh and len(trows) == len(jrows) == n_rows
    for a, b in zip(trows, jrows):
        assert a[:3] == b[:3]   # frame, step, rate
        assert abs(float(a[-1]) - float(b[-1])) <= PSNR_TOL
    return trows


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


# -- encode_ply ---------------------------------------------------------------


@pytest.fixture(scope="module")
def raw_ply(tmp_path_factory):
    pts, rgb = synth.raw_surface_cloud(3000, seed=3)
    path = tmp_path_factory.mktemp("ply") / "raw.ply"
    save_ply_ascii(path, pts.astype(np.float64), rgb.astype(int))
    return path


@pytest.mark.parametrize("extra", [[], ["--code-geometry"], ["--predict"],
                                   ["--quant-mode", "deadzone", "--entropy", "auto"]],
                         ids=["plain", "code_geometry", "predict", "deadzone_auto"])
def test_encode_ply_target_bpp_matches_jax(tmp_path, capsys, raw_ply, extra):
    common = ["--input", str(raw_ply), "--voxelize", "--depth", "6", "--bucket", "512",
              "--platform", "cpu", "--target-bpp", "6"] + extra
    out = {}
    for name, cli in (("j", jply), ("t", tply)):
        out[name] = _run(capsys, cli, common + ["--save-streams", str(tmp_path / name),
                                                "--csv", str(tmp_path / f"{name}.csv")],
                         tmp_path / name)
    assert out["t"] == out["j"]
    assert any("-> step" in ln for ln in out["t"])
    files = _files(tmp_path / "t")
    assert list(files) == ["frame0001_bpp6.r3tc"] and files == _files(tmp_path / "j")
    s = FrameStream.from_bytes(files["frame0001_bpp6.r3tc"])
    assert s.bpp() <= 6.0 * 1.001
    assert s.predict == ("--predict" in extra)
    assert (s.geometry is not None) == ("--code-geometry" in extra)
    _same_rows(tmp_path / "j.csv", tmp_path / "t.csv", 0)   # the header only


# -- encode_3dgs --------------------------------------------------------------


@pytest.fixture(scope="module")
def gs_ply(tmp_path_factory):
    V, attrs = synthetic_gs_frame(n=900, depth=6, seed=2)
    vsize, vmin = 0.05, np.array([-1.6, -1.6, -1.6])
    path = tmp_path_factory.mktemp("gs") / "vox.ply"
    # a voxelized 3DGS PLY holds the integer voxel positions (voxelize_3dgs)
    save_ply_3dgs(path, V, attrs[:, 0:4], attrs[:, 4:7],
                  attrs[:, 7], attrs[:, 8:], voxel_size=vsize, vmin=vmin)
    return path


@pytest.mark.parametrize("extra", [[], ["--per-attribute", "--steps", "1", "2"],
                                   ["--code-geometry"]],
                         ids=["plain", "per_attribute", "code_geometry"])
def test_encode_3dgs_target_bpp_matches_jax(tmp_path, capsys, gs_ply, extra):
    common = ["--input", str(gs_ply), "--depth", "6", "--bucket", "1024",
              "--platform", "cpu", "--target-bpp", "20"] + extra
    out = {}
    for name, cli in (("j", jgs), ("t", tgs)):
        out[name] = _run(capsys, cli, common + ["--save-streams", str(tmp_path / name),
                                                "--csv", str(tmp_path / f"{name}.csv")],
                         tmp_path / name)
    assert out["t"] == out["j"]
    assert any(ln.startswith("target 20.000 bpp -> step") for ln in out["t"])
    files = _files(tmp_path / "t")
    assert list(files) == ["gs_bpp20.r3tc"] and files == _files(tmp_path / "j")
    s = FrameStream.from_bytes(files["gs_bpp20.r3tc"])
    assert s.bpp() <= 20.0 * 1.001 and s.n_channels == 56
    assert (len(set(s.steps)) > 1) == ("--per-attribute" in extra)


def test_encode_3dgs_steps_note(tmp_path, capsys, gs_ply):
    argv = ["--input", str(gs_ply), "--depth", "6", "--platform", "cpu", "--steps", "3",
            "--target-bpp", "20", "--csv", str(tmp_path / "x.csv")]
    assert tgs.main(argv) == 0
    assert "note: --steps ignored in --target-bpp mode" in capsys.readouterr().err


# -- encode_dataset -----------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Frames 1, 2, 4 and 5 of an 8iVFBv2 sequence at J=6 (3 is missing): a
    drifting cloud of integer colours (non-integer once in YUV)."""
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(5)
    base = rng.integers(0, 64, (1400, 3))
    cols = np.clip(np.stack([base[:, 0] * 3, base[:, 1] * 2 + 40, 200 - base[:, 2] * 2], 1)
                   + rng.integers(-6, 7, (1400, 3)), 0, 255)
    for k, fr in enumerate((1, 2, 4, 5)):
        pts = np.clip(base + k, 0, 63)
        _, first = np.unique(morton_codes_np(pts, 6), return_index=True)
        keep = first[: 900 + 150 * k]
        save_ply_ascii(frame_path("8iVFBv2", "loot", fr, str(root)),
                       pts[keep].astype(float), cols[keep].astype(float), width=63)
    return root


_MODES = {
    "target": [],
    "cbr": ["--cbr"],
    "cbr_burst": ["--cbr", "--cbr-burst", "0.2"],   # caps the credit
    "cbr_gop": ["--cbr", "--cbr-gop", "2"],
    "burst_only": ["--cbr-burst", "1.0"],
    "two_pass": ["--two-pass"],
}


@pytest.mark.parametrize("mode", list(_MODES))
def test_encode_dataset_rate_modes_match_jax(tmp_path, capsys, tree, mode):
    target = 3.0
    common = ["--dataset", "8iVFBv2", "--sequence", "loot", "--data-root", str(tree),
              "--frames", "1", "5", "--bucket", "512", "--platform", "cpu",
              "--target-bpp", f"{target:g}"] + _MODES[mode]
    out = {}
    with pytest.warns(UserWarning, match="file not found"):
        for name, cli in (("j", jds), ("t", tds)):
            out[name] = _run(capsys, cli, common + ["--csv", str(tmp_path / f"{name}.csv")])
    assert out["t"] == out["j"]
    rows = _same_rows(tmp_path / "j.csv", tmp_path / "t.csv", 4)
    assert [int(r[0]) for r in rows] == [1, 2, 4, 5]
    bpp = [float(r[2]) for r in rows]
    if mode == "two_pass":
        assert len({r[1] for r in rows}) == 1
        assert out["t"][0].startswith("two-pass: step")
    elif mode in ("target",):
        assert max(bpp) <= target * 1.001
    else:
        gop = 2 if mode == "cbr_gop" else len(bpp)
        for g0 in range(0, len(bpp), gop):
            seg = bpp[g0:g0 + gop]
            for k in range(len(seg)):
                assert np.mean(seg[: k + 1]) <= target * 1.001, (mode, seg)
        assert any("credit" in ln for ln in out["t"])


def test_two_pass_mixed_depth_returns_2(tmp_path, capsys, tree):
    root = tmp_path / "mixed"
    for fr, depth in ((1, 6), (2, 5)):
        pts = np.unique(np.random.default_rng(fr).integers(0, 2**depth, (300, 3)), axis=0)
        save_ply_ascii(frame_path("8iVFBv2", "loot", fr, str(root)), pts.astype(float),
                       np.full((len(pts), 3), 100.0), width=2**depth - 1)
    argv = ["--dataset", "8iVFBv2", "--sequence", "loot", "--data-root", str(root),
            "--frames", "1", "2", "--platform", "cpu", "--target-bpp", "2", "--two-pass",
            "--csv", str(tmp_path / "x.csv")]
    errs = []
    for cli in (jds, tds):
        capsys.readouterr()
        assert cli.main(argv) == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0] == errs[1] and "one octree depth" in errs[1]
