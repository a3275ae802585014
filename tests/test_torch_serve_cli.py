"""The port's tiled CLIs and serving CLI against the JAX package's on the
same files, and the port's PNG writer.

- ``encode_ply --tiles``, ``encode_3dgs --tiles`` and ``encode_dataset
  --tiles``: float64 on non-integer attributes, so the ``.r3tt`` / ``.r3ts``
  bytes equal the JAX CLI's (ROADMAP queue A, item 6's gate, with no tie on
  these inputs), the CSV rows equal apart from the time columns (PSNR within
  1e-6 dB).
- ``decode`` of R3TT, ``--roi`` and ``.r3ts[r3tt]`` ``--all-frames`` /
  ``--frame-index``: positions equal; colours within one level (attributes
  1e-9 apart may round to either side of an integer), 3DGS attributes
  within 1e-6.
- ``serve`` on ``.r3tc``, ``.r3ts``, ``.r3tt`` and ``.r3ts[r3tt]``: the same
  PNG names, pixels (read with PIL) within one level, the JSON line's keys
  and values equal but ``wall_s`` / ``out``, exit 2 on a colour stream.
"""

import csv
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from raht3dgs_tpu.cli import decode as jdec, encode_3dgs as jenc3, encode_dataset as jencd
from raht3dgs_tpu.cli import encode_ply as jencp, serve as jserve
from raht3dgs_tpu.codec.bitstream import write_sequence
from raht3dgs_tpu.codec.geometry import geometry_from_positions
from raht3dgs_tpu.models import pipeline as jp, tiling as jt
from raht3dgs_tpu.models.temporal import SequenceCodec
from raht3dgs_tpu.ops.prelude import morton_codes_np
from raht3dgs_tpu_torch.cli import decode as tdec, encode_3dgs as tenc3, encode_dataset as tencd
from raht3dgs_tpu_torch.cli import encode_ply as tencp, serve as tserve
from raht3dgs_tpu_torch.io.ply import read_compressed_3dgs_ply, read_ply_8i, save_ply_3dgs
from raht3dgs_tpu_torch.io.ply import save_ply_ascii
from raht3dgs_tpu_torch.io.png import png_bytes, write_png
from test_torch_encode_dataset import _write_tree

SERVE_ARGS = ["--views", "2", "--size", "64", "--max-per-tile", "512", "--platform", "cpu"]
GS_DEPTH = 5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_jax_cache(monkeypatch):
    # the JAX CLIs turn on a persistent compile cache unless this is empty
    monkeypatch.setenv("RAHT3DGS_COMPILE_CACHE", "")


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _same_rows(trows, jrows):
    assert len(trows) == len(jrows) > 0
    for a, b in zip(trows, jrows):
        assert set(a) == set(b)
        for k in a:
            if "time" in k.lower():
                continue
            if "psnr" in k.lower():
                assert abs(float(a[k]) - float(b[k])) <= 1e-6, k
            else:
                assert a[k] == b[k], k


def _same_colour_ply(pt, pj):
    Vt, Ct, _ = read_ply_8i(str(pt))
    Vj, Cj, _ = read_ply_8i(str(pj))
    np.testing.assert_array_equal(Vt, Vj)
    assert len(Vt) > 0 and float(np.abs(Ct - Cj).max()) <= 1
    return Vt


# --- encode_ply --tiles / decode of R3TT ------------------------------------

@pytest.fixture(scope="module")
def colour_ply(tmp_path_factory):
    """~1 500 unique voxels at J=7 with integer RGB (non-integer YUV)."""
    rng = np.random.default_rng(3)
    depth = 7
    pts = rng.integers(0, 2**depth, (4000, 3))
    _, first = np.unique(morton_codes_np(pts, depth), return_index=True)
    V = pts[np.sort(first)][:1500]
    rgb = np.clip(V @ rng.uniform(0.4, 1.4, (3, 3)) + rng.normal(0, 6, (len(V), 3)), 0, 255)
    path = tmp_path_factory.mktemp("ply") / "frame.ply"
    save_ply_ascii(path, V.astype(float), np.floor(rgb), width=2**depth - 1)
    return path, V


@pytest.mark.parametrize("geometry", [False, True])
def test_encode_ply_tiles_and_decode_match_jax(colour_ply, tmp_path, geometry):
    src, V = colour_ply
    extra = ["--code-geometry"] if geometry else []
    for name, cli in (("j", jencp), ("t", tencp)):
        assert cli.main(["--input", str(src), "--steps", "8", "--tiles", "2",
                         "--dtype", "float64", "--save-streams", str(tmp_path / name),
                         "--platform", "cpu", "--csv", str(tmp_path / f"{name}.csv"),
                         *extra]) == 0
    blob_t = (tmp_path / "t" / "frame_tiled2.r3tt").read_bytes()
    assert blob_t == (tmp_path / "j" / "frame_tiled2.r3tt").read_bytes()
    _same_rows(_rows(tmp_path / "t.csv"), _rows(tmp_path / "j.csv"))
    pos = [] if geometry else ["--positions", str(src)]
    for what, args in (("full", []), ("roi", ["--roi", "0", "0", "0", "64", "128", "64"])):
        for name, cli in (("j", jdec), ("t", tdec)):
            assert cli.main(["--stream", str(tmp_path / "t" / "frame_tiled2.r3tt"),
                             "--output", str(tmp_path / f"{what}_{name}.ply"),
                             "--dtype", "float64", "--platform", "cpu", *pos, *args]) == 0
        Vd = _same_colour_ply(tmp_path / f"{what}_t.ply", tmp_path / f"{what}_j.ply")
        if what == "roi":
            assert np.all(Vd[:, [0, 2]] < 64) and len(Vd) < len(V)
        else:
            assert len(Vd) == len(V)


def test_decode_refusals_match_jax(colour_ply, tmp_path):
    """--roi on a monolithic stream, --lod / --progressive on a tiled one:
    the JAX CLI's messages."""
    src, _ = colour_ply
    assert tencp.main(["--input", str(src), "--steps", "8", "--save-streams",
                       str(tmp_path / "m"), "--platform", "cpu", "--csv",
                       str(tmp_path / "m.csv")]) == 0
    assert tencp.main(["--input", str(src), "--steps", "8", "--tiles", "1",
                       "--code-geometry", "--save-streams", str(tmp_path / "m"),
                       "--platform", "cpu", "--csv", str(tmp_path / "m.csv")]) == 0
    mono = sorted((tmp_path / "m").glob("*.r3tc"))[0]
    tiled = tmp_path / "m" / "frame_tiled1.r3tt"
    cases = [([str(mono), "--positions", str(src), "--roi", "0", "0", "0", "1", "1", "1"],
              "needs a tiled"),
             ([str(tiled), "--lod", "3"], "monolithic"),
             ([str(tiled), "--progressive", "8"], "monolithic")]
    for argv, match in cases:
        msgs = []
        for cli in (jdec, tdec):
            with pytest.raises(SystemExit, match=match) as e:
                cli.main(["--stream", *argv, "--output", str(tmp_path / "o.ply"),
                          "--platform", "cpu"])
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("argv,match", [
    (["--steps", "8", "16", "--tiles", "2", "--save-streams", "s"], "exactly one"),
    (["--steps", "8", "--tiles", "2"], "--save-streams"),
])
def test_encode_ply_tiles_guards_match_jax(colour_ply, tmp_path, argv, match):
    src, _ = colour_ply
    msgs = []
    for cli in (jencp, tencp):
        with pytest.raises(SystemExit, match=match) as e:
            cli.main(["--input", str(src), "--platform", "cpu", "--csv",
                      str(tmp_path / "g.csv"), *argv])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# --- encode_3dgs --tiles ------------------------------------------------------

def _gs_attrs(rng, n):
    attrs = np.concatenate([rng.normal(size=(n, 4)), rng.uniform(0.02, 0.06, (n, 3)),
                            rng.uniform(0.3, 1.0, (n, 1)), rng.normal(0, 0.3, (n, 48))],
                           axis=1)
    attrs[:, 0:4] /= np.linalg.norm(attrs[:, 0:4], axis=1, keepdims=True)
    return attrs


@pytest.fixture(scope="module")
def gs_ply(tmp_path_factory):
    """A compressed-3DGS PLY: ~700 voxels at J=6, 56 channels."""
    rng = np.random.default_rng(5)
    depth = 6
    pts = rng.integers(0, 2**depth, (2000, 3))
    _, first = np.unique(morton_codes_np(pts, depth), return_index=True)
    V = pts[np.sort(first)][:700]
    attrs = _gs_attrs(rng, len(V))
    path = tmp_path_factory.mktemp("gs") / "gs.ply"
    save_ply_3dgs(path, means=V.astype(np.float64), quats=attrs[:, 0:4], scales=attrs[:, 4:7],
                  opacities=attrs[:, 7], colors=attrs[:, 8:], voxel_size=0.25,
                  vmin=np.array([-1.0, -2.0, 0.5]))
    save_ply_ascii(path.with_name("pos.ply"), V.astype(float), np.zeros((len(V), 3)),
                   width=2**depth - 1)
    return path, V, depth


@pytest.mark.parametrize("extra", [["--code-geometry"], ["--per-attribute"]],
                         ids=["geometry", "per_attribute"])
def test_encode_3dgs_tiles_and_decode_match_jax(gs_ply, tmp_path, extra):
    src, V, depth = gs_ply
    for name, cli in (("j", jenc3), ("t", tenc3)):
        assert cli.main(["--input", str(src), "--depth", str(depth), "--steps", "0.02",
                         "--tiles", "2", "--dtype", "float64", "--platform", "cpu",
                         "--save-streams", str(tmp_path / name), "--csv",
                         str(tmp_path / f"{name}.csv"), *extra]) == 0
    blob = tmp_path / "t" / "gs_tiled2_step0.02.r3tt"
    assert blob.read_bytes() == (tmp_path / "j" / "gs_tiled2_step0.02.r3tt").read_bytes()
    _same_rows(_rows(tmp_path / "t.csv"), _rows(tmp_path / "j.csv"))
    pos = [] if "--code-geometry" in extra else ["--positions", str(src.with_name("pos.ply"))]
    half = str(1 << (depth - 1))
    for what, args in (("full", []), ("roi", ["--roi", "0", "0", "0", half, half, half])):
        for name, cli in (("j", jdec), ("t", tdec)):
            assert cli.main(["--stream", str(blob), "--output",
                             str(tmp_path / f"{what}_{name}.ply"), "--color-space", "3dgs",
                             "--dtype", "float64", "--platform", "cpu", *pos, *args]) == 0
        vt, at, vst, vmt = read_compressed_3dgs_ply(str(tmp_path / f"{what}_t.ply"))
        vj, aj, vsj, vmj = read_compressed_3dgs_ply(str(tmp_path / f"{what}_j.ply"))
        np.testing.assert_array_equal(vt, vj)
        assert float(np.abs(at - aj).max()) <= 1e-6
        assert vst == vsj == pytest.approx(0.25)
        np.testing.assert_array_equal(vmt, vmj)
        assert (0 < len(vt) < len(V)) if what == "roi" else len(vt) == len(V)


def test_encode_3dgs_tiles_refuses_target_bpp(gs_ply, tmp_path):
    src, _, depth = gs_ply
    msgs = []
    for cli in (jenc3, tenc3):
        with pytest.raises(SystemExit, match="do not combine") as e:
            cli.main(["--input", str(src), "--depth", str(depth), "--tiles", "2",
                      "--target-bpp", "2.0", "--save-streams", str(tmp_path),
                      "--platform", "cpu", "--csv", str(tmp_path / "r.csv")])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# --- encode_dataset --tiles ---------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("tree"), "8iVFBv2", np.random.default_rng(0))


def test_encode_dataset_tiles_and_decode_match_jax(tree, tmp_path):
    """.r3ts of .r3tt frames: the JAX CLI's bytes and rows; --all-frames and
    --frame-index 1 --roi of both decoders agree, the ROI clipping frame 1."""
    for name, cli in (("j", jencd), ("t", tencd)):
        assert cli.main(["--dataset", "8iVFBv2", "--sequence", "loot", "--data-root",
                         str(tree), "--frames", "1", "4", "--steps", "4", "--tiles", "2",
                         "--dtype", "float64", "--save-sequence", str(tmp_path / f"{name}.r3ts"),
                         "--platform", "cpu", "--csv", str(tmp_path / f"{name}.csv")]) == 0
    seq = tmp_path / "t.r3ts"
    assert seq.read_bytes() == (tmp_path / "j.r3ts").read_bytes()
    _same_rows(_rows(tmp_path / "t.csv"), _rows(tmp_path / "j.csv"))
    for name, cli in (("j", jdec), ("t", tdec)):
        out = str(tmp_path / f"all_{name}_{{i}}.ply")
        assert cli.main(["--stream", str(seq), "--all-frames", "--output", out,
                         "--dtype", "float64", "--platform", "cpu"]) == 0
        assert cli.main(["--stream", str(seq), "--frame-index", "1", "--roi", "0", "0", "0",
                         "16", "16", "16", "--output", str(tmp_path / f"roi_{name}.ply"),
                         "--dtype", "float64", "--platform", "cpu"]) == 0
    for i in range(3):
        _same_colour_ply(tmp_path / f"all_t_{i}.ply", tmp_path / f"all_j_{i}.ply")
    Vr = _same_colour_ply(tmp_path / "roi_t.ply", tmp_path / "roi_j.ply")
    Va, Ca, _ = read_ply_8i(str(tmp_path / "all_t_1.ply"))
    keep = np.all(Va < 16, axis=1)
    Vr2, Cr, _ = read_ply_8i(str(tmp_path / "roi_t.ply"))
    np.testing.assert_array_equal(Vr, Va[keep])
    np.testing.assert_array_equal(Cr, Ca[keep])


@pytest.mark.parametrize("extra", [["--inter"], ["--batch", "2"]])
def test_encode_dataset_tiles_refusals_match_jax(tree, tmp_path, extra, capsys):
    argv = ["--dataset", "8iVFBv2", "--sequence", "loot", "--data-root", str(tree),
            "--frames", "1", "2", "--steps", "4", "--tiles", "2", "--save-sequence",
            str(tmp_path / "s.r3ts"), "--platform", "cpu", "--csv", str(tmp_path / "r.csv"),
            *extra]
    errs = []
    for cli in (jencd, tencd):
        assert cli.main(argv) == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0] == errs[1] and "intra-only" in errs[0]


# --- serve --------------------------------------------------------------------

@pytest.fixture(scope="module")
def containers(tmp_path_factory):
    """The four containers cli.serve reads, 56 float32 channels at J=5:
    a frame, an I/P sequence (both with geometry sections), a tiled frame
    and a sequence of two tiled frames."""
    d = tmp_path_factory.mktemp("containers")
    rng = np.random.default_rng(7)
    pts = rng.integers(2, 2**GS_DEPTH - 3, (900, 3))
    codes = np.unique(morton_codes_np(pts, GS_DEPTH))[:160]
    from raht3dgs_tpu_torch.ops.morton import morton_decode

    pos = morton_decode(torch.as_tensor(codes.astype(np.int64)), GS_DEPTH).numpy()
    attrs = _gs_attrs(rng, len(pos))
    codec = jp.AttributeCodec(GS_DEPTH, dtype=jnp.float32)
    frame = jp.prepare_voxel_frame(pos, attrs, GS_DEPTH, bucket=64, dtype=jnp.float32)
    stream = codec.encode(frame, 0.002).stream
    stream.geometry = geometry_from_positions(pos, GS_DEPTH)
    (d / "frame.r3tc").write_bytes(stream.to_bytes())
    positions = [pos, np.clip(pos + [1, 0, -1], 0, 2**GS_DEPTH - 1),
                 np.clip(pos + [2, 0, -2], 0, 2**GS_DEPTH - 1)]
    frames = [jp.prepare_voxel_frame(p, attrs, GS_DEPTH, bucket=64, dtype=jnp.float32)
              for p in positions]
    streams, _ = SequenceCodec(GS_DEPTH, gop=2, adaptive=False, dtype=jnp.float32) \
        .encode_sequence(frames, steps=0.002)
    assert [s.inter for s in streams] == [False, True, False]
    for s, p in zip(streams, positions):
        s.geometry = geometry_from_positions(p, GS_DEPTH)
    write_sequence(d / "seq.r3ts", streams)
    blobs = [jt.encode_tiled_frame(p, attrs, GS_DEPTH, 1, codec, 0.002, code_geometry=True,
                                   vmin=np.array([-1.0, -1.0, -1.0]), width=2.0)[0]
             for p in positions[:2]]
    (d / "frame.r3tt").write_bytes(blobs[0])
    write_sequence(d / "tiled.r3ts", blobs)
    colour = jp.prepare_voxel_frame(pos, rng.normal(size=(len(pos), 3)), GS_DEPTH, bucket=64)
    (d / "colour.r3tc").write_bytes(jp.AttributeCodec(GS_DEPTH).encode(colour, 4.0)
                                    .stream.to_bytes())
    return d


SERVE_CASES = {
    "r3tc": ("frame.r3tc", []),
    "r3tc_u8": ("frame.r3tc", ["--u8"]),
    "r3ts_u8": ("seq.r3ts", ["--u8"]),
    "r3ts_progressive": ("seq.r3ts", ["--progressive", "64"]),
    "r3tt_margin": ("frame.r3tt", ["--margin", "4.0"]),
    "r3tt_roi": ("frame.r3tt", ["--roi", "0", "0", "0", "16", "16", "16", "--u8"]),
    "r3ts_r3tt": ("tiled.r3ts", ["--u8"]),
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serve_cli_matches_jax(containers, tmp_path, capsys, case):
    name, extra = SERVE_CASES[case]
    recs, names = {}, {}
    for pkg, cli in (("j", jserve), ("t", tserve)):
        assert cli.main(["--stream", str(containers / name), "--out", str(tmp_path / pkg),
                         *SERVE_ARGS, *extra]) == 0
        recs[pkg] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        names[pkg] = sorted(p.name for p in (tmp_path / pkg).glob("*.png"))
    assert names["t"] == names["j"] and len(names["t"]) == recs["t"]["images"] > 0
    assert set(recs["t"]) == set(recs["j"])
    for k in recs["t"]:
        if k not in ("wall_s", "out"):
            assert recs["t"][k] == recs["j"][k], k
    for n in names["t"]:
        a = np.asarray(Image.open(tmp_path / "t" / n))
        b = np.asarray(Image.open(tmp_path / "j" / n))
        assert a.shape == b.shape == (64, 64, 3)
        assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1
    if case == "r3ts_progressive":
        assert names["t"][0].startswith("frame_0000") and recs["t"]["frames"] == 2
        assert not any("frame_0001" in n for n in names["t"])
    if case == "r3tt_roi":
        assert recs["t"]["bricks_served"] < recs["t"]["bricks_total"]


def test_serve_cli_refuses_colour_stream(containers, tmp_path, capsys):
    errs = []
    for cli in (jserve, tserve):
        assert cli.main(["--stream", str(containers / "colour.r3tc"), "--out",
                         str(tmp_path / "v"), *SERVE_ARGS]) == 2
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and "3DGS" in errs[1]


# --- io/png -------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (64, 64), (33, 130)])
def test_png_reads_back_bitwise(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    write_png(tmp_path / "a.png", img)
    back = Image.open(tmp_path / "a.png")
    assert back.mode == "RGB" and back.size == (shape[1], shape[0])
    np.testing.assert_array_equal(np.asarray(back), img)
    assert (tmp_path / "a.png").read_bytes() == png_bytes(img)


@pytest.mark.parametrize("bad", [np.zeros((4, 4, 3), np.float32), np.zeros((4, 4), np.uint8),
                                 np.zeros((4, 4, 4), np.uint8)])
def test_png_refuses_other_images(bad):
    with pytest.raises(ValueError, match="uint8"):
        png_bytes(bad)


def test_render_views_are_written_as_png(tmp_path):
    """The render comparison's dumps go through io/png: PIL reads back the
    display convention of each view and the side-by-side comparison."""
    from raht3dgs_tpu_torch.eval.render import _save_views

    rng = np.random.default_rng(0)
    o = rng.uniform(-0.2, 1.2, (2, 16, 24, 3)).astype(np.float32)
    r = rng.uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    _save_views(tmp_path, o, r)
    for i in range(2):
        a = (np.clip(o[i], 0, 1) * 255).astype(np.uint8)
        b = (np.clip(r[i], 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"view_{i:03d}_original.png")), a)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"view_{i:03d}_merged.png")), b)
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / f"view_{i:03d}_comparison.png")),
            np.concatenate([a, b], axis=1))
