"""The port's dataset path against the JAX package's: the dataset registry
(``io/datasets.py``) and the ``encode_dataset`` CLI, frame loop and
``--batch``, on 8iVFBv2- and MVUB-layout trees written into a temporary
directory.

The CLI converts RGB to YUV, so the colours are not integers and float64
streams are byte-identical (ROADMAP queue A, item 6's gate): ``Frame``,
``Quantization_Step`` and ``Rate_bpp`` equal the JAX CLI's, ``psnr``
within 1e-6 dB; the time columns are not compared."""

import csv
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

from raht3dgs_tpu.cli import encode_dataset as jcli
from raht3dgs_tpu.io import datasets as jds
from raht3dgs_tpu.io.ply import save_ply_ascii
from raht3dgs_tpu.ops.prelude import morton_codes_np
from raht3dgs_tpu_torch.cli import encode_dataset as tcli
from raht3dgs_tpu_torch.io import datasets as tds
from raht3dgs_tpu_torch.io.ply import read_ply_8i
from raht3dgs_tpu_torch.utils import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = {"8iVFBv2": ("loot", 5), "MVUB": ("sarah9", 9)}
STEPS = ["4", "8"]


def _write_tree(root, dataset, rng):
    """Frames 1, 2 and 4 of a sequence (3 is missing): the drifting cloud
    of ``tests/test_encode_dataset_cli.py``'s fixture, in the dataset's
    directory layout, depth from the 8i header or MVUB's fixed 9."""
    sequence, depth = LAYOUTS[dataset]
    base = rng.integers(0, 2**depth, (800, 3))
    base_cols = rng.integers(0, 255, (800, 3))
    for k, fr in enumerate((1, 2, 4)):
        pts = np.clip(base + k, 0, 2**depth - 1)
        _, first = np.unique(morton_codes_np(pts, depth), return_index=True)
        path = tds.frame_path(dataset, sequence, fr, str(root))
        save_ply_ascii(path, pts[first].astype(float), base_cols[first].astype(float),
                       width=2**depth - 1 if dataset == "8iVFBv2" else None)
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    rng = np.random.default_rng(0)
    return {name: _write_tree(tmp_path_factory.mktemp(name), name, rng) for name in LAYOUTS}


_RUNS = {}


def _run(trees, tmp_path_factory, dataset, pkg, batch, extra=()):
    """Rows of one CLI run (cached: each package runs each mode once)."""
    key = (dataset, pkg, batch, tuple(extra))
    if key not in _RUNS:
        out = tmp_path_factory.mktemp("csv") / f"{pkg}.csv"
        argv = ["--dataset", dataset, "--sequence", LAYOUTS[dataset][0],
                "--data-root", str(trees[dataset]), "--frames", "1", "4",
                "--steps", *STEPS, "--platform", "cpu", "--csv", str(out)]
        if batch:
            argv += ["--batch", "2"]
        argv += list(extra)
        with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
            # the JAX CLI turns on a persistent compile cache unless this is empty
            mp.setenv("RAHT3DGS_COMPILE_CACHE", "")
            warnings.simplefilter("ignore")  # the missing frame's warning
            assert (jcli if pkg == "jax" else tcli).main(argv) == 0
        with open(out) as f:
            _RUNS[key] = list(csv.DictReader(f))
    return _RUNS[key]


@pytest.mark.parametrize("batch", [0, 2], ids=["frame_loop", "batch2"])
@pytest.mark.parametrize("dataset", list(LAYOUTS))
def test_cli_rows_match_jax_cli(trees, tmp_path_factory, dataset, batch):
    jrows = _run(trees, tmp_path_factory, dataset, "jax", batch)
    trows = _run(trees, tmp_path_factory, dataset, "torch", batch)
    # rows only for the real frames 1, 2 and 4, one per step (a batch
    # writes its frames' rows step by step)
    assert sorted((r["Frame"], r["Quantization_Step"]) for r in trows) == \
        [(f, s) for f in ("1", "2", "4") for s in STEPS]
    assert list(trows[0]) == list(jrows[0])
    for a, b in zip(trows, jrows):
        assert (a["Frame"], a["Quantization_Step"], a["Rate_bpp"]) == \
            (b["Frame"], b["Quantization_Step"], b["Rate_bpp"])
        assert abs(float(a["psnr"]) - float(b["psnr"])) <= 1e-6
    if batch:  # the shared transform's time rides every step's rows
        assert all(float(r["RAHT_transform_time"]) > 0 for r in trows)


@pytest.mark.parametrize("batch", [0, 2], ids=["frame_loop", "batch2"])
@pytest.mark.parametrize("entropy", ["rac", "auto"])
def test_entropy_rows_match_jax_cli(trees, tmp_path_factory, entropy, batch):
    extra = ["--entropy", entropy]
    jrows = _run(trees, tmp_path_factory, "8iVFBv2", "jax", batch, extra)
    trows = _run(trees, tmp_path_factory, "8iVFBv2", "torch", batch, extra)
    rlgr = {(r["Frame"], r["Quantization_Step"]): float(r["Rate_bpp"])
            for r in _run(trees, tmp_path_factory, "8iVFBv2", "torch", batch)}
    assert len(trows) == len(jrows) == 6
    for a, b in zip(trows, jrows):
        assert (a["Frame"], a["Quantization_Step"], a["Rate_bpp"]) == \
            (b["Frame"], b["Quantization_Step"], b["Rate_bpp"])
        assert abs(float(a["psnr"]) - float(b["psnr"])) <= 1e-6
        assert float(a["Rate_bpp"]) <= rlgr[(a["Frame"], a["Quantization_Step"])] \
            or entropy == "rac"


def test_code_geometry_is_accepted_as_in_jax(trees, tmp_path_factory):
    # without --save-sequence/--tiles/--target-bpp the flag writes nothing
    # more in either package: the rows are those of a run without it
    plain = _run(trees, tmp_path_factory, "MVUB", "torch", 0)
    got = _run(trees, tmp_path_factory, "MVUB", "torch", 0, ["--code-geometry"])
    want = _run(trees, tmp_path_factory, "MVUB", "jax", 0, ["--code-geometry"])
    for a, b, c in zip(got, want, plain):
        assert a["Rate_bpp"] == b["Rate_bpp"] == c["Rate_bpp"]


@pytest.mark.parametrize("dataset", list(LAYOUTS))
def test_batched_rates_equal_frame_loop(trees, tmp_path_factory, dataset):
    loop = _run(trees, tmp_path_factory, dataset, "torch", 0)
    batched = _run(trees, tmp_path_factory, dataset, "torch", 2)
    def by_row(rows):
        return {(r["Frame"], r["Quantization_Step"]): (r["Rate_bpp"], r["psnr"]) for r in rows}

    assert len(batched) == len(loop) == 6 and by_row(batched) == by_row(loop)


def test_dataset_config_matches_jax():
    assert tds.DATASET_CONFIG == jds.DATASET_CONFIG
    assert tds.MVUB_DEPTH == jds.MVUB_DEPTH
    for ds, seqs in jds.DATASET_CONFIG.items():
        for seq in seqs:
            assert tds.get_pointcloud_n_frames(ds, seq) == jds.get_pointcloud_n_frames(ds, seq)


@pytest.mark.parametrize("dataset,sequence,frame", [
    ("8iVFBv2", "redandblack", 1), ("8iVFBv2", "loot", 300), ("8iVFBv2", "soldier", 17),
    ("MVUB", "andrew9", 1), ("MVUB", "sarah9", 207), ("MVUB", "phil9", 100),
])
def test_frame_path_matches_jax(dataset, sequence, frame):
    got = tds.frame_path(dataset, sequence, frame, "/data")
    assert got == jds.frame_path(dataset, sequence, frame, "/data") and got is not None


@pytest.mark.parametrize("args,match", [
    (("8iVFBv2", "loot", 0), "outside"), (("8iVFBv2", "loot", 301), "outside"),
    (("MVUB", "sarah9", 208), "outside"), (("KITTI", "loot", 1), "unknown dataset"),
    (("8iVFBv2", "sarah9", 1), "unknown sequence"),
])
def test_bad_frames_warn_and_give_none(tmp_path, args, match):
    for mod in (tds, jds):
        with pytest.warns(UserWarning, match=match):
            assert mod.frame_path(*args, str(tmp_path)) is None
        with pytest.warns(UserWarning, match=match):
            assert mod.get_pointcloud(*args, str(tmp_path)) is None
        if match != "outside":
            with pytest.warns(UserWarning, match=match):
                assert mod.get_pointcloud_n_frames(*args[:2]) is None


@pytest.mark.parametrize("dataset", list(LAYOUTS))
def test_get_pointcloud_matches_jax(trees, dataset):
    sequence, depth = LAYOUTS[dataset]
    root = str(trees[dataset])
    for fr in (1, 2, 4):
        got, want = tds.get_pointcloud(dataset, sequence, fr, root), \
            jds.get_pointcloud(dataset, sequence, fr, root)
        assert got[2] == want[2] == depth
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for mod in (tds, jds):  # the missing frame, and an unreadable one
        with pytest.warns(UserWarning, match="file not found"):
            assert mod.get_pointcloud(dataset, sequence, 3, root) is None
    bad = tds.frame_path(dataset, sequence, 5, root)
    with open(bad, "w") as f:
        f.write("not a ply\n")
    for mod in (tds, jds):
        with pytest.warns(UserWarning, match="error reading"):
            assert mod.get_pointcloud(dataset, sequence, 5, root) is None
    os.remove(bad)


def _argv(tmp_path, extra):
    return ["--dataset", "8iVFBv2", "--sequence", "loot", "--data-root", str(tmp_path),
            "--platform", "cpu", "--csv", str(tmp_path / "x.csv"), *extra]


@pytest.mark.parametrize("extra,item", [
    (["--save-sequence", "s.r3ts", "--steps", "4"], 15),
    (["--tiles", "3", "--save-sequence", "s.r3ts", "--steps", "4"], 15),
    (["--target-bpp", "2.0"], 14),
    (["--target-bpp", "2.0", "--cbr"], 14),
    (["--target-bpp", "2.0", "--two-pass"], 14),
    (["--inter", "--steps", "4"], 14),
    (["--predict"], 13),
])
def test_unported_flags_exit_naming_their_item(tmp_path, extra, item):
    with pytest.raises(SystemExit, match=f"item {item}"):
        tcli.main(_argv(tmp_path, extra))


@pytest.mark.parametrize("extra", [
    ["--save-sequence", "s.r3ts"],                    # more than one step
    ["--cbr"], ["--cbr-gop", "4"],                    # rate control without a target
    ["--tiles", "3"], ["--tiles", "3", "--save-sequence", "s", "--steps", "4", "--batch", "2"],
    ["--two-pass"], ["--target-bpp", "1", "--two-pass", "--batch", "2"],
    ["--target-bpp", "1", "--batch", "2"],
    ["--inter"], ["--inter", "--steps", "4", "--batch", "2"],
])
def test_argument_errors_match_jax(tmp_path, monkeypatch, extra):
    monkeypatch.setenv("RAHT3DGS_COMPILE_CACHE", "")
    assert tcli.main(_argv(tmp_path, extra)) == 2
    assert jcli.main(_argv(tmp_path, extra)) == 2


def test_unknown_sequence_returns_1(tmp_path):
    # before any other check, and before the device is asked for
    with pytest.warns(UserWarning, match="unknown sequence"):
        assert tcli.main(["--dataset", "MVUB", "--sequence", "loot", "--predict",
                          "--csv", str(tmp_path / "x.csv")]) == 1
    assert not (tmp_path / "x.csv").exists()


def test_cli_subprocess_and_profile(trees, tmp_path):
    out = tmp_path / "log.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "raht3dgs_tpu_torch.cli.encode_dataset", "--dataset", "MVUB",
         "--sequence", "sarah9", "--data-root", str(trees["MVUB"]), "--frames", "2", "4",
         "--steps", "8", "--batch", "4", "--no-decode", "--dtype", "float32", "--csv", str(out),
         "--platform", "cpu", "--profile", str(tmp_path / "trace")],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "frame 3: load failed, skipping" in proc.stderr
    assert "frames 2..4 done (batched)" in proc.stdout
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert [r["Frame"] for r in rows] == ["2", "4"]
    assert all(float(r["Rate_bpp"]) > 0 and r["psnr"] == "nan" for r in rows)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_dataset_frame_generator(tmp_path):
    V, C = synth.dataset_frame(3, n_points=20000, depth=7, seed=1)
    V2, C2 = synth.dataset_frame(3, n_points=20000, depth=7, seed=1)
    assert np.array_equal(V, V2) and np.array_equal(C, C2)
    codes = synth.morton_codes_np(V, 7)
    assert (np.diff(codes) > 0).all()                      # unique, Morton-sorted
    assert V.min() >= 0 and V.max() < 128 and C.min() >= 0 and C.max() <= 255
    assert len(V) != len(synth.dataset_frame(4, n_points=20000, depth=7, seed=1)[0])
    path = tmp_path / "f.ply"
    synth.write_binary_ply(path, V.astype(np.float32), C.astype(np.uint8), width=127)
    V3, C3, depth = read_ply_8i(path)
    assert depth == 7 and np.array_equal(V3, V) and np.array_equal(C3, C)
