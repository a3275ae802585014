"""The port's sequence CLIs against the JAX package's: ``encode_dataset
--save-sequence`` (frame loop, ``--batch``, the rate modes) and ``--inter``
(``--gop``, ``--search-stride``, ``--target-bpp``, ``--code-geometry``),
then ``decode`` of the ``.r3ts`` files with ``--all-frames``,
``--frame-index`` and ``--lod``, on the small 8iVFBv2 tree of
``tests/test_torch_encode_dataset.py`` (frames 1, 2 and 4 of a drifting
cloud; frame 3 missing).

Float64 on YUV colours (not integers): the CSV rows (``Frame``,
``Quantization_Step``, ``Rate_bpp``; ``psnr`` within 1e-6 dB) and the
``.r3ts`` bytes must equal the JAX CLI's (ROADMAP queue A, item 6's gate,
with no tie on these inputs). Decodes write ``--color-space raw`` so the
attributes land in full precision beside the PLY: positions equal, the
attributes within 1e-9 of the JAX decoder's on the same file, and a
P-frame's ``--frame-index`` output bitwise frame i of ``--all-frames``."""

import csv
import warnings

import numpy as np
import pytest
import torch

from raht3dgs_tpu.cli import decode as jdec, encode_dataset as jenc
from raht3dgs_tpu_torch.cli import decode as tdec, encode_dataset as tenc
from raht3dgs_tpu_torch.codec.bitstream import SequenceReader
from raht3dgs_tpu_torch.io.ply import read_ply
from test_torch_encode_dataset import _write_tree

ATTR_TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("tree"), "8iVFBv2", np.random.default_rng(0))


_RUNS = {}


def _encode(tree, tmp_path_factory, pkg, extra):
    """(CSV rows, .r3ts path) of one --save-sequence run, cached."""
    key = (pkg, tuple(extra))
    if key not in _RUNS:
        out = tmp_path_factory.mktemp("seq")
        argv = ["--dataset", "8iVFBv2", "--sequence", "loot", "--data-root", str(tree),
                "--frames", "1", "4", "--platform", "cpu", "--csv", str(out / "r.csv"),
                "--save-sequence", str(out / "s.r3ts"), *extra]
        with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
            mp.setenv("RAHT3DGS_COMPILE_CACHE", "")
            warnings.simplefilter("ignore")  # the missing frame's warning
            assert (jenc if pkg == "jax" else tenc).main(argv) == 0
        with open(out / "r.csv") as f:
            _RUNS[key] = (list(csv.DictReader(f)), out / "s.r3ts")
    return _RUNS[key]


MODES = {
    "frame_loop": ["--steps", "4"],
    "batch2": ["--steps", "4", "--batch", "2"],
    "target_geometry": ["--target-bpp", "2.0", "--code-geometry"],
    "two_pass": ["--target-bpp", "2.0", "--two-pass", "--code-geometry"],
    "cbr": ["--target-bpp", "2.0", "--cbr"],
    "inter": ["--inter", "--steps", "4"],
    "inter_gop2_stride4": ["--inter", "--steps", "4", "--gop", "2", "--search-stride", "4"],
    "inter_target": ["--inter", "--target-bpp", "2.0"],
    "inter_geometry": ["--inter", "--steps", "4", "--code-geometry"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_save_sequence_matches_jax(tree, tmp_path_factory, mode):
    jrows, jseq = _encode(tree, tmp_path_factory, "jax", MODES[mode])
    trows, tseq = _encode(tree, tmp_path_factory, "torch", MODES[mode])
    assert [r["Frame"] for r in trows] == ["1", "2", "4"]
    for a, b in zip(trows, jrows):
        assert (a["Frame"], a["Quantization_Step"], a["Rate_bpp"]) == \
            (b["Frame"], b["Quantization_Step"], b["Rate_bpp"])
        assert abs(float(a["psnr"]) - float(b["psnr"])) <= 1e-6
    assert tseq.read_bytes() == jseq.read_bytes()
    frames = list(SequenceReader(tseq))
    assert len(frames) == 3
    inter = [s.inter for s in frames]
    if "--inter" in MODES[mode]:
        assert inter[0] is False and any(inter)
        if mode == "inter_gop2_stride4":
            assert inter[2] is False
    else:
        assert not any(inter)
    if "--code-geometry" in MODES[mode]:
        # P-frames carry temporal geometry (profiles 1/2/4/5), I-frames intra
        assert all((s.geometry[0] in (0, 3)) != s.inter for s in frames)


def test_batch_and_frame_loop_write_the_same_sequence(tree, tmp_path_factory):
    _, loop = _encode(tree, tmp_path_factory, "torch", MODES["frame_loop"])
    _, batch = _encode(tree, tmp_path_factory, "torch", MODES["batch2"])
    assert loop.read_bytes() == batch.read_bytes()


def _decode(pkg, seq, out, extra):
    argv = ["--stream", str(seq), "--output", str(out), "--color-space", "raw",
            "--platform", "cpu", *extra]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAHT3DGS_COMPILE_CACHE", "")
        assert (jdec if pkg == "jax" else tdec).main(argv) == 0


def _read(path):
    v = read_ply(path).vertices
    V = np.stack([v["x"], v["y"], v["z"]], axis=1)
    return V, np.load(str(path) + ".attrs.npy")


@pytest.mark.parametrize("mode", ["inter_geometry", "target_geometry"])
@pytest.mark.parametrize("src", ["jax", "torch"])
def test_decode_sequences_match_jax(tree, tmp_path_factory, tmp_path, src, mode):
    """--all-frames without positions, --frame-index of an I-frame and of a
    P-frame (replaying the chain), on the sequences of both packages."""
    _, seq = _encode(tree, tmp_path_factory, src, MODES[mode])
    for pkg in ("jax", "torch"):
        _decode(pkg, seq, tmp_path / f"{pkg}_all_{{i}}.ply", ["--all-frames"])
        for i in (0, 2):
            _decode(pkg, seq, tmp_path / f"{pkg}_one{i}.ply", ["--frame-index", str(i)])
    for i in range(3):
        Vt, At = _read(tmp_path / f"torch_all_{i}.ply")
        Vj, Aj = _read(tmp_path / f"jax_all_{i}.ply")
        assert np.array_equal(Vt, Vj) and float(np.abs(At - Aj).max()) <= ATTR_TOL
    for i in (0, 2):
        Vo, Ao = _read(tmp_path / f"torch_one{i}.ply")
        Va, Aa = _read(tmp_path / f"torch_all_{i}.ply")
        assert np.array_equal(Vo, Va) and np.array_equal(Ao, Aa)
        Vj, Aj = _read(tmp_path / f"jax_one{i}.ply")
        assert np.array_equal(Vo, Vj) and float(np.abs(Ao - Aj).max()) <= ATTR_TOL
    if mode == "inter_geometry":
        assert SequenceReader(seq).frame(2).inter


@pytest.mark.parametrize("src", ["jax", "torch"])
def test_decode_lod_of_a_sequence_frame_matches_jax(tree, tmp_path_factory, tmp_path,
                                                   src, capsys):
    _, seq = _encode(tree, tmp_path_factory, src, MODES["target_geometry"])
    for lod in (2, 4):
        for pkg in ("jax", "torch"):
            _decode(pkg, seq, tmp_path / f"{pkg}{lod}.ply", ["--frame-index", "1",
                                                            "--lod", str(lod)])
        Vt, At = _read(tmp_path / f"torch{lod}.ply")
        Vj, Aj = _read(tmp_path / f"jax{lod}.ply")
        assert np.array_equal(Vt, Vj) and float(np.abs(At - Aj).max()) <= ATTR_TOL
        assert np.array_equal(np.load(tmp_path / f"torch{lod}.ply.cellw.npy"),
                              np.load(tmp_path / f"jax{lod}.ply.cellw.npy"))
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("LOD ")]
    assert len(lines) == 4 and lines[0] == lines[1] and lines[2] == lines[3]


@pytest.mark.parametrize("extra,match", [
    (["--frame-index", "2", "--lod", "2"], "predicted"),
    (["--all-frames", "--lod", "2"], "standalone intra"),
    (["--all-frames"], "placeholder"),
    (["--frame-index", "0", "--lod", "2", "--progressive", "4"], "mutually exclusive"),
])
def test_decode_sequence_refusals_match_jax(tree, tmp_path_factory, tmp_path, extra, match):
    _, seq = _encode(tree, tmp_path_factory, "torch", MODES["inter_geometry"])
    out = tmp_path / ("o_{i}.ply" if extra == ["--all-frames", "--lod", "2"] else "o.ply")
    for cli in (tdec, jdec):
        with pytest.raises(SystemExit, match=match):
            cli.main(["--stream", str(seq), "--output", str(out), "--platform", "cpu",
                      *extra])
