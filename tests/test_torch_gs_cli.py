"""The port's 3DGS CLIs against the JAX package's on the same files:
checkpoint or PLY -> voxelize_3dgs -> encode_3dgs -> decode --color-space
3dgs, each PLY read across packages, and the debug CLI's report.

Tolerances: voxel positions and counts exact; merged float32 attributes
to 1e-5 relative; CSV rows equal apart from the time columns, with the
rate within 0.1% and the PSNRs within 1e-6 dB (float64) / 1e-3 dB
(float32); decoded attributes (written as float32) within 1e-6 of the JAX
decode of the same stream.
"""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from raht3dgs_tpu.cli import decode as jdec, encode_3dgs as jenc, voxelize_3dgs as jvox
from raht3dgs_tpu.cli import encode_3dgs_debug as jdbg
from raht3dgs_tpu.io.ply import read_compressed_3dgs_ply as jread
from raht3dgs_tpu_torch.cli import decode as tdec, encode_3dgs as tenc, voxelize_3dgs as tvox
from raht3dgs_tpu_torch.cli import encode_3dgs_debug as tdbg
from raht3dgs_tpu_torch.io.ply import read_compressed_3dgs_ply as tread, save_ply_3dgs
from raht3dgs_tpu_torch.utils import device as tdev

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PSNR_TOL = {"float64": 1e-6, "float32": 1e-3}


@pytest.fixture
def no_jax_cache(monkeypatch):
    # the JAX CLIs turn on a persistent compile cache unless this is empty
    monkeypatch.setenv("RAHT3DGS_COMPILE_CACHE", "")


@pytest.fixture
def ckpt(tmp_path, rng):
    n = 600
    splats = {
        "means": torch.tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32),
        "quats": torch.tensor(rng.normal(size=(n, 4)), dtype=torch.float32),
        "scales": torch.tensor(np.log(rng.uniform(0.01, 0.05, (n, 3))), dtype=torch.float32),
        "opacities": torch.tensor(rng.normal(size=(n,)), dtype=torch.float32),
        "sh0": torch.tensor(rng.normal(size=(n, 1, 3)), dtype=torch.float32),
        "shN": torch.tensor(rng.normal(size=(n, 15, 3)) * 0.1, dtype=torch.float32),
    }
    path = tmp_path / "ckpt.pt"
    torch.save({"splats": splats}, path)
    return path


def _csv(path):
    lines = path.read_text().strip().splitlines()
    return lines[0], [ln.split(",") for ln in lines[1:]]


def _voxelize_both(tmp_path, src_flag, src):
    """voxelize_3dgs with both packages; returns the two compressed PLYs."""
    out = {}
    for name, cli in (("j", jvox), ("t", tvox)):
        odir = tmp_path / f"vox_{name}"
        assert cli.main([src_flag, str(src), "--depth", "6", "--output-dir", str(odir),
                         "--render", "none", "--platform", "cpu",
                         "--csv", str(tmp_path / f"vox_{name}.csv")]) == 0
        out[name] = odir / "compressed_Nvox_gaussians.ply"
    jh, jrows = _csv(tmp_path / "vox_j.csv")
    th, trows = _csv(tmp_path / "vox_t.csv")
    assert th == jh and len(trows) == len(jrows) == 1
    # name, J, N, Nvox, ratio; sizes (last three): the same files
    assert trows[0][:5] == jrows[0][:5] and trows[0][-3:] == jrows[0][-3:]
    for read in (jread, tread):  # each package reads the other's PLY
        a, b = read(out["t"]), read(out["j"])
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_allclose(a[1], b[1], rtol=1e-5, atol=1e-6)
        assert a[2] == b[2]
        np.testing.assert_array_equal(a[3], b[3])
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ckpt_chain_matches_jax_clis(ckpt, tmp_path, no_jax_cache, dtype):
    voxply = str(_voxelize_both(tmp_path, "--ckpt", ckpt)["j"])
    for name, cli in (("j", jenc), ("t", tenc)):
        assert cli.main(["--input", voxply, "--steps", "0.01", "0.1", "--platform", "cpu",
                         "--dtype", dtype, "--save-streams", str(tmp_path / name),
                         "--csv", str(tmp_path / f"{name}.csv")]) == 0
    (jh, jrows), (th, trows) = _csv(tmp_path / "j.csv"), _csv(tmp_path / "t.csv")
    assert th == jh and len(trows) == len(jrows) == 2
    for a, b in zip(trows, jrows):
        assert len(a) == 20 and a[:2] == b[:2]
        assert abs(float(a[2]) - float(b[2])) <= 1e-3 * float(b[2])
        for x, y in zip(a[15:], b[15:]):
            assert abs(float(x) - float(y)) <= _PSNR_TOL[dtype] + 1e-6
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == \
        ["gs_step0.01.r3tc", "gs_step0.1.r3tc"]

    # the JAX package's stream through both decode CLIs
    stream = str(tmp_path / "j" / "gs_step0.01.r3tc")
    for name, cli in (("j", jdec), ("t", tdec)):
        assert cli.main(["--stream", stream, "--positions", voxply, "--output",
                         str(tmp_path / f"rec_{name}.ply"), "--color-space", "3dgs",
                         "--platform", "cpu", "--dtype", dtype]) == 0
    for read in (jread, tread):
        a, b = read(tmp_path / "rec_t.ply"), read(tmp_path / "rec_j.ply")
        np.testing.assert_array_equal(a[0], b[0])
        assert np.abs(a[1] - b[1]).max() <= 1e-6
        assert a[2] == b[2]
        np.testing.assert_array_equal(a[3], b[3])
    v0, a0, vs0, vmin0 = tread(voxply)
    v1, a1, vs1, vmin1 = tread(tmp_path / "rec_t.ply")
    np.testing.assert_array_equal(v0, v1)
    assert vs0 == vs1
    np.testing.assert_array_equal(vmin0, vmin1)
    assert np.abs(a0 - a1).max() < 0.02  # the step 0.01 bound
    np.testing.assert_allclose(np.linalg.norm(a1[:, :4], axis=1), 1.0, atol=1e-5)
    assert (a1[:, 4:7] >= 0).all() and (0 <= a1[:, 7]).all() and (a1[:, 7] <= 1).all()


@pytest.mark.parametrize("entropy", ["rac", "auto"])
def test_code_geometry_chain_decodes_without_positions_as_jax(ckpt, tmp_path, no_jax_cache,
                                                               capsys, entropy):
    voxply = str(_voxelize_both(tmp_path, "--ckpt", ckpt)["j"])
    for name, cli in (("j", jenc), ("t", tenc)):
        assert cli.main(["--input", voxply, "--steps", "0.05", "--platform", "cpu",
                         "--code-geometry", "--entropy", entropy,
                         "--save-streams", str(tmp_path / name),
                         "--csv", str(tmp_path / f"{name}.csv")]) == 0
    geo = [ln for ln in capsys.readouterr().out.splitlines() if "bits/voxel" in ln]
    assert len(geo) == 2 and geo[0] == geo[1]
    (_, jrows), (_, trows) = _csv(tmp_path / "j.csv"), _csv(tmp_path / "t.csv")
    assert abs(float(trows[0][2]) - float(jrows[0][2])) <= 1e-3 * float(jrows[0][2])
    blobs = {n: (tmp_path / n / "gs_step0.05.r3tc").read_bytes() for n in "jt"}
    from raht3dgs_tpu_torch.codec.bitstream import FrameStream

    ts, js = (FrameStream.from_bytes(blobs[n]) for n in "tj")
    assert ts.geometry == js.geometry and ts.entropy_map is not None
    # the JAX stream without --positions through both decoders, and the
    # port's decode given the compressed-3DGS PLY: the same Gaussians
    stream = str(tmp_path / "j" / "gs_step0.05.r3tc")
    for name, cli in (("j", jdec), ("t", tdec)):
        assert cli.main(["--stream", stream, "--output", str(tmp_path / f"self_{name}.ply"),
                         "--color-space", "3dgs", "--platform", "cpu"]) == 0
    assert tdec.main(["--stream", stream, "--positions", voxply, "--output",
                      str(tmp_path / "with.ply"), "--color-space", "3dgs",
                      "--platform", "cpu"]) == 0
    a, b, w = (tread(tmp_path / f) for f in ("self_t.ply", "self_j.ply", "with.ply"))
    np.testing.assert_array_equal(a[0], b[0])
    assert np.abs(a[1] - b[1]).max() <= 1e-6
    from raht3dgs_tpu_torch.ops.morton import morton_codes_np

    order = np.argsort(morton_codes_np(w[0], 6))
    np.testing.assert_array_equal(a[0], w[0][order])
    np.testing.assert_array_equal(a[1], w[1][order])
    assert a[2] == w[2] and np.allclose(a[3], w[3])


def test_ply_input_and_per_attribute_match_jax(tmp_path, rng, no_jax_cache):
    n = 800
    scene = tmp_path / "scene.ply"
    save_ply_3dgs(scene, rng.uniform(-2, 2, (n, 3)), rng.normal(size=(n, 4)),
                  np.abs(rng.normal(size=(n, 3))) * 0.01, rng.uniform(0, 1, n),
                  rng.normal(size=(n, 48)))
    voxply = str(_voxelize_both(tmp_path, "--ply", scene)["t"])
    for name, cli in (("j", jenc), ("t", tenc)):
        assert cli.main(["--input", voxply, "--steps", "8", "--per-attribute",
                         "--entropy-chunk", "64", "--platform", "cpu",
                         "--csv", str(tmp_path / f"{name}.csv")]) == 0
    (_, jrows), (_, trows) = _csv(tmp_path / "j.csv"), _csv(tmp_path / "t.csv")
    assert trows[0][:2] == jrows[0][:2]
    assert abs(float(trows[0][2]) - float(jrows[0][2])) <= 1e-3 * float(jrows[0][2])
    for x, y in zip(trows[0][15:], jrows[0][15:]):
        assert abs(float(x) - float(y)) <= 2e-6


def test_debug_report_matches_jax(ckpt, tmp_path, no_jax_cache, capsys):
    voxply = str(_voxelize_both(tmp_path, "--ckpt", ckpt)["j"])
    capsys.readouterr()
    outs = {}
    for name, cli in (("j", jdbg), ("t", tdbg)):
        assert cli.main(["--input", voxply, "--platform", "cpu", "--strategy", "hybrid"]) == 0
        outs[name] = capsys.readouterr().out.splitlines()
    j, t = outs["j"], outs["t"]
    cut = t.index("recommended: importance-weighted (quats get the most levels)")
    assert t[:cut + 1] == j[:cut + 1]          # the three strategies, digit for digit
    assert "=== HYBRID STRATEGY ENCODE ===" in t
    for a, b in zip(t[cut + 1:], j[cut + 1:]):
        if "psnr" in a:
            assert a.split(":")[0] == b.split(":")[0]
            assert abs(float(a.split()[1]) - float(b.split()[1])) <= 0.01
    for grp in ("quats", "scales", "opacity", "colors"):
        assert any(f"psnr_{grp}" in ln for ln in t)


def test_voxelize_3dgs_subprocess(ckpt, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "raht3dgs_tpu_torch.cli.voxelize_3dgs", "--ckpt", str(ckpt),
         "--depth", "5", "--output-dir", str(tmp_path / "out"), "--render", "none",
         "--platform", "cpu", "--csv", str(tmp_path / "v.csv")],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Gaussians: 600 ->" in proc.stdout
    assert sorted(glob.glob(str(tmp_path / "out" / "*.ply"))) == [
        str(tmp_path / "out" / "compressed_Nvox_gaussians.ply"),
        str(tmp_path / "out" / "original_N_gaussians.ply")]


@pytest.mark.parametrize("cli,extra,item", [
    (tenc, ["--tiles", "3"], None),
    (tenc, ["--tiles", "3", "--target-bpp", "1.0"], None),   # refused, as in the JAX CLI
])
def test_unported_3dgs_options_exit_naming_their_item(tmp_path, no_jax_cache, cli, extra,
                                                      item):
    """``--tiles`` is ported (item None): on a compressed-3DGS PLY it writes
    the JAX CLI's ``.r3tt`` bytes and CSV row (float64), and with
    ``--target-bpp`` both CLIs refuse with the same message."""
    assert item is None and cli is tenc
    rng = np.random.default_rng(2)
    pts = np.unique(rng.integers(0, 32, (400, 3)), axis=0)[:250]
    A = np.concatenate([rng.normal(size=(len(pts), 4)), rng.uniform(0.01, 0.1, (len(pts), 3)),
                        rng.uniform(0.2, 0.9, (len(pts), 1)), rng.normal(0, 0.3, (len(pts), 48))],
                       axis=1)
    src = tmp_path / "gs.ply"
    save_ply_3dgs(src, means=pts.astype(float), quats=A[:, :4], scales=A[:, 4:7],
                  opacities=A[:, 7], colors=A[:, 8:], voxel_size=0.05,
                  vmin=np.array([-1.0, 0.0, 1.0]))
    argv = ["--input", str(src), "--depth", "5", "--steps", "0.02", "--dtype", "float64",
            "--platform", "cpu", "--code-geometry"] + extra
    if "--target-bpp" in extra:
        msgs = []
        for enc in (jenc, tenc):
            with pytest.raises(SystemExit, match="do not combine") as e:
                enc.main(argv + ["--save-streams", str(tmp_path / "s")])
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        return
    for name, enc in (("j", jenc), ("t", tenc)):
        assert enc.main(argv + ["--save-streams", str(tmp_path / name),
                                "--csv", str(tmp_path / f"{name}.csv")]) == 0
    blob = (tmp_path / "t" / "gs_tiled3_step0.02.r3tt").read_bytes()
    assert blob[:4] == b"R3TT" and blob == (tmp_path / "j" / "gs_tiled3_step0.02.r3tt").read_bytes()
    (jh, jrows), (th, trows) = _csv(tmp_path / "j.csv"), _csv(tmp_path / "t.csv")
    assert th == jh and len(trows) == len(jrows) == 1 and trows[0][:3] == jrows[0][:3]


def test_predict_chain_matches_jax_clis(ckpt, tmp_path, no_jax_cache):
    """encode_3dgs --predict -> decode --color-space 3dgs in both packages:
    the same streams, CSV rows and decoded attributes."""
    voxply = str(_voxelize_both(tmp_path, "--ckpt", ckpt)["j"])
    for name, cli in (("j", jenc), ("t", tenc)):
        assert cli.main(["--input", voxply, "--steps", "0.01", "0.1", "--platform", "cpu",
                         "--predict", "--save-streams", str(tmp_path / name),
                         "--csv", str(tmp_path / f"{name}.csv")]) == 0
    (jh, jrows), (th, trows) = _csv(tmp_path / "j.csv"), _csv(tmp_path / "t.csv")
    assert th == jh and len(trows) == len(jrows) == 2
    for a, b in zip(trows, jrows):
        assert a[:3] == b[:3] and a[15:] == b[15:]
    assert float(trows[0][15]) > float(trows[1][15])
    for step in ("0.01", "0.1"):
        blob = (tmp_path / "t" / f"gs_step{step}.r3tc").read_bytes()
        assert blob == (tmp_path / "j" / f"gs_step{step}.r3tc").read_bytes()
    stream = str(tmp_path / "t" / "gs_step0.01.r3tc")
    for name, cli in (("j", jdec), ("t", tdec)):
        assert cli.main(["--stream", stream, "--positions", voxply, "--output",
                         str(tmp_path / f"rec_{name}.ply"), "--color-space", "3dgs",
                         "--platform", "cpu"]) == 0
    a, b = tread(tmp_path / "rec_t.ply"), tread(tmp_path / "rec_j.ply")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert np.abs(a[1] - tread(voxply)[1]).max() < 0.02  # the step 0.01 bound


def _scene_ply(tmp_path, rng, n=800):
    scene = tmp_path / "scene.ply"
    save_ply_3dgs(scene, rng.uniform(-2, 2, (n, 3)), rng.normal(size=(n, 4)),
                  np.abs(rng.normal(size=(n, 3))) * 0.05, rng.uniform(0, 1, n),
                  rng.normal(size=(n, 48)) * 0.3)
    return scene


def _printed_psnrs(out):
    """The numbers of the render lines a 3DGS CLI prints: the render
    comparison's, or the ablation's one line a group."""
    lines = out.splitlines()
    if "=== RENDERING ABLATION (one reconstructed group at a time) ===" in lines:
        lines = lines[lines.index("=== RENDERING ABLATION (one reconstructed group at a "
                                  "time) ===") + 1:-1]
    else:
        lines = [ln for ln in lines if "PSNR (" in ln]
    return lines, [[float(x) for x in re.findall(r"-?\d+\.\d+|inf", ln.split(":", 1)[1])]
                   for ln in lines]


@pytest.mark.parametrize("cli,extra,src", [
    (tvox, [], "ckpt"),                       # the JAX default, --render auto
    (tvox, [], "ply"),
    (tvox, ["--render", "preview"], "ckpt"),
    (tenc, ["--render", "jax"], "ckpt"),
    (tenc, ["--render", "auto"], "ply"),
    (tdbg, ["--ablation"], "ckpt"),
])
def test_render_options_match_jax_clis(ckpt, tmp_path, rng, no_jax_cache, capsys, cli, extra,
                                       src):
    """Each render choice of the three 3DGS CLIs against the JAX CLI on the
    same files: the printed PSNRs within 0.011 dB (two decimals), the CSVs
    as in the chains above; ``auto`` takes the package's rasterizer
    (``jax``) with gsplat absent."""
    path = ckpt if src == "ckpt" else _scene_ply(tmp_path, rng)
    small = ["--views", "2", "--image-size", "64"]
    if cli is not tvox:
        voxply = str(_voxelize_both(tmp_path, f"--{src}", path)["t"])
    capsys.readouterr()
    outs = {}
    for name, pkg in (("j", {tvox: jvox, tenc: jenc, tdbg: jdbg}[cli]), ("t", cli)):
        csv = str(tmp_path / f"{name}.csv")
        if cli is tvox:
            argv = [f"--{src}", str(path), "--depth", "6", "--output-dir",
                    str(tmp_path / f"vox_{name}"), "--render-dir", str(tmp_path / f"png_{name}"),
                    "--csv", csv] + small
        elif cli is tenc:
            argv = ["--input", voxply, "--steps", "0.05", "0.5", "--csv", csv]
        else:
            argv = ["--input", voxply] + small
        assert pkg.main(argv + ["--platform", "cpu"] + extra) == 0
        outs[name] = capsys.readouterr().out
        if cli is not tdbg:
            outs[name + "csv"] = _csv(tmp_path / f"{name}.csv")
    (jl, jn), (tl, tn) = _printed_psnrs(outs["j"]), _printed_psnrs(outs["t"])
    assert [ln.split(":")[0] for ln in tl] == [ln.split(":")[0] for ln in jl] and tl
    for a, b in zip(tn, jn):
        assert len(a) == len(b) and all(x == y or abs(x - y) <= 0.011 for x, y in zip(a, b))
    backend = "preview" if "preview" in extra else "jax"
    if cli is not tdbg:
        assert f"PSNR ({backend})" in tl[0]
        (jh, jrows), (th, trows) = outs["jcsv"], outs["tcsv"]
        assert th == jh and len(trows) == len(jrows)
        for a, b in zip(trows, jrows):
            if cli is tvox:
                assert a[:5] == b[:5] and a[-3:] == b[-3:]
            else:
                assert a[:2] == b[:2] and abs(float(a[2]) - float(b[2])) <= 1e-3 * float(b[2])
                for x, y in zip(a[15:], b[15:]):
                    assert abs(float(x) - float(y)) <= 1e-6 + 1e-6
    else:
        assert sorted(ln.split()[0] for ln in tl) == ["colors", "opacity", "quats", "scales"]
        assert all(all(np.isfinite(x)) for x in tn)
        assert outs["t"].splitlines()[-1] == outs["j"].splitlines()[-1]  # the worst group
    if cli is tvox:
        pngs = sorted(p.name for p in (tmp_path / "png_t").iterdir())
        assert pngs == sorted(p.name for p in (tmp_path / "png_j").iterdir()) and len(pngs) == 6


def test_decode_3dgs_refuses_narrow_streams_and_plain_positions(tmp_path):
    from raht3dgs_tpu_torch.cli import encode_ply
    from raht3dgs_tpu_torch.io.ply import save_ply_ascii
    from raht3dgs_tpu_torch.utils import synth

    pts, rgb = synth.raw_surface_cloud(2000, seed=1)
    raw = tmp_path / "raw.ply"
    save_ply_ascii(raw, pts.astype(np.float64), rgb.astype(int))
    assert encode_ply.main(["--input", str(raw), "--voxelize", "--depth", "5", "--steps", "4",
                            "--platform", "cpu", "--save-streams", str(tmp_path / "s"),
                            "--csv", str(tmp_path / "c.csv")]) == 0
    stream = str(tmp_path / "s" / "frame0001_step4.r3tc")
    with pytest.raises(SystemExit, match="56-channel layout, stream has 3"):
        tdec.main(["--stream", stream, "--positions", str(raw), "--output",
                   str(tmp_path / "o.ply"), "--color-space", "3dgs", "--platform", "cpu"])


def test_decode_3dgs_refuses_positions_without_3dgs_properties(ckpt, tmp_path):
    from raht3dgs_tpu_torch.io.ply import save_ply_ascii

    assert tvox.main(["--ckpt", str(ckpt), "--depth", "5", "--output-dir",
                      str(tmp_path / "v"), "--render", "none", "--platform", "cpu",
                      "--csv", str(tmp_path / "v.csv")]) == 0
    voxply = tmp_path / "v" / "compressed_Nvox_gaussians.ply"
    assert tenc.main(["--input", str(voxply), "--depth", "5", "--steps", "1", "--platform",
                      "cpu", "--save-streams", str(tmp_path / "s"),
                      "--csv", str(tmp_path / "e.csv")]) == 0
    V = tread(voxply)[0]
    plain = tmp_path / "plain.ply"
    save_ply_ascii(plain, V.astype(np.float64))
    with pytest.raises(SystemExit, match="not a compressed-3DGS PLY"):
        tdec.main(["--stream", str(tmp_path / "s" / "gs_step1.r3tc"), "--positions",
                   str(plain), "--output", str(tmp_path / "o.ply"), "--color-space", "3dgs",
                   "--platform", "cpu"])


def test_3dgs_entry_points_refuse_silent_cpu(monkeypatch, rng):
    from raht3dgs_tpu_torch.models.gs_codec import encode_gs_frame
    from raht3dgs_tpu_torch.models.gs_merge import merge_gaussian_clusters
    from raht3dgs_tpu_torch.models.gs_voxelize import compress_to_nvox

    monkeypatch.setattr(tdev, "cuda_available", lambda: False)
    scene = {k: rng.uniform(0.1, 1, shape) for k, shape in (
        ("means", (20, 3)), ("quats", (20, 4)), ("scales", (20, 3)),
        ("opacities", (20,)), ("colors", (20, 48)))}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compress_to_nvox(scene, depth=3)
    assert compress_to_nvox(scene, depth=3, device="cpu").n_voxels > 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encode_gs_frame(np.zeros((1, 3)), np.zeros((1, 56)), depth=3, steps=(1,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        merge_gaussian_clusters(*scene.values(), np.zeros(20, np.int64), 1)
    for cli, argv in ((tvox, ["--ckpt", "c.pt", "--render", "none"]),
                      (tenc, ["--input", "x.ply"]),
                      (tdbg, ["--input", "x.ply"]),
                      (tdec, ["--stream", "x.r3tc", "--positions", "p.ply", "--output",
                              "o.ply", "--color-space", "3dgs"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)
