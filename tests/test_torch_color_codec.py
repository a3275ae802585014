"""The port's colour codec, pipelined sweep and CLIs against the JAX package's.

Gates (ROADMAP queue A, item 6): ``encode_sweep`` gives the bytes of
per-step ``encode``; with non-integer colours at float64 it gives the JAX
package's bytes. CSV rows: Rate_bpp within 0.1% (symbols may differ at
quantization ties) and PSNR within 1e-6 dB (float64) / 1e-3 dB (float32).
The decode CLI writes the JAX decode CLI's bytes for the same stream.
"""

import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import unique_voxel_cloud
from raht3dgs_tpu.cli import decode as jdec, encode_ply as jenc
from raht3dgs_tpu.codec.bitstream import FrameStream as JaxStream
from raht3dgs_tpu.models import color_codec as jcc, pipeline as jp
from raht3dgs_tpu_torch.cli import decode as tdec, encode_ply as tenc
from raht3dgs_tpu_torch.models import color_codec as tcc, pipeline as tp
from raht3dgs_tpu_torch.utils import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TORCH = {jnp.float64: torch.float64, jnp.float32: torch.float32}
_PSNR_TOL = {"float64": 1e-6, "float32": 1e-3}


@pytest.fixture
def no_jax_cache(monkeypatch):
    # the JAX CLIs turn on a persistent compile cache unless this is empty
    monkeypatch.setenv("RAHT3DGS_COMPILE_CACHE", "")


def _frame(rng, n=1500, depth=7, integer=True):
    pts, _, attrs = unique_voxel_cloud(rng, n, depth)
    return pts, (np.floor(attrs) if integer else attrs), depth


# -- the pipelined sweep ---------------------------------------------------


@pytest.mark.parametrize("quant_mode,chunk", [("mid", 0), ("deadzone", 0), ("mid", 256)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_encode_sweep_bytes_equal_per_step_encode(rng, dtype, quant_mode, chunk):
    pts, attrs, depth = _frame(rng)
    frame = tp.prepare_voxel_frame(pts, attrs, depth, bucket=512, dtype=dtype, device="cpu")
    codec = tp.AttributeCodec(depth, dtype=dtype, quant_mode=quant_mode, chunk=chunk,
                              device="cpu")
    steps = [1, 2.5, 4, 16, 64]
    sweep = codec.encode_sweep(frame, steps)
    assert len(sweep) == len(steps)
    for s, enc in zip(steps, sweep):
        assert enc.stream.to_bytes() == codec.encode(frame, s).stream.to_bytes()
        assert set(enc.timer.stages) == {"Quant_time", "Entropy_enc_time"}
    # hoisted transform: the same bytes when the caller passes it in
    coeffs, order, _, _ = codec.transform(frame)
    again = codec.encode_sweep(frame, steps[:2], coeffs=coeffs, order=order)
    assert [e.stream.to_bytes() for e in again] == [e.stream.to_bytes() for e in sweep[:2]]
    assert codec.encode_sweep(frame, []) == []


def test_encode_sweep_matches_jax_noninteger_f64():
    pts, _, attrs = unique_voxel_cloud(np.random.default_rng(42), 600, 6)
    jf = jp.prepare_voxel_frame(pts, attrs, 6, bucket=1024)
    tf = tp.voxel_frame_from_arrays(np.array(jf.codes), np.array(jf.attributes),
                                    np.array(jf.weights), jf.n_voxels, 6, jf.vmin,
                                    jf.width, device="cpu")
    steps = [2.0, 4.0, 16.0]
    want = [e.stream.to_bytes() for e in jp.AttributeCodec(6).encode_sweep(jf, steps)]
    got = [e.stream.to_bytes()
           for e in tp.AttributeCodec(6, device="cpu").encode_sweep(tf, steps)]
    assert got == want


def test_encode_sweep_entropy_failure_raises_and_joins(rng, monkeypatch):
    pts, attrs, depth = _frame(rng, n=300, depth=6)
    frame = tp.prepare_voxel_frame(pts, attrs, depth, bucket=512, device="cpu")
    codec = tp.AttributeCodec(depth, device="cpu")
    real = tp.build_entropy_stream
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("entropy coder failed")
        return real(*a, **k)

    monkeypatch.setattr(tp, "build_entropy_stream", flaky)
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="entropy coder failed"):
        codec.encode_sweep(frame, [1, 2, 4, 8])
    assert threading.active_count() == threads  # the fetch thread has ended


def test_fetch_failure_reaches_the_consumer():
    qs = [torch.zeros(2, 8, dtype=torch.int32), torch.zeros(3, 8, dtype=torch.int32)]
    got = []
    with pytest.raises(RuntimeError):
        for arr, wait_s in tp._fetched_symbols(qs, window=1):
            got.append(arr.copy())
            assert wait_s >= 0.0
    assert len(got) == 1


def test_fetched_buffers_are_reused_in_order():
    # a buffer the consumer holds must not be refilled under it: with a
    # short switch interval the fetch thread runs between the consumer's
    # two reads of every value, and any refill would show
    qs = [torch.full((4, 257), k, dtype=torch.int32) for k in range(300)]
    threads = threading.active_count()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        seen = []
        for arr, _ in tp._fetched_symbols(qs, window=2):
            first = arr.copy()
            for _ in range(50):
                threading.Event().wait(0)  # yield to the fetch thread
            assert np.array_equal(arr, first)
            seen.append(int(first[0, 0]))
    finally:
        sys.setswitchinterval(interval)
    assert seen == list(range(300))
    assert threading.active_count() == threads  # the fetch thread has ended


# -- encode_color_frame and its CSV ----------------------------------------


@pytest.mark.parametrize("decode", [True, False])
@pytest.mark.parametrize("jdt", [jnp.float64, jnp.float32])
def test_encode_color_frame_rows_match_jax(rng, jdt, decode):
    pts, _, _ = unique_voxel_cloud(rng, 1200, 7)
    perm = rng.permutation(len(pts))  # not in Morton order
    pts = pts[perm]
    rgb = rng.integers(0, 256, (len(pts), 3)).astype(np.float64)
    kw = dict(depth=7, steps=(1, 4, 16), bucket=512, decode=decode)
    want = jcc.encode_color_frame(pts, rgb, dtype=jdt, **kw)
    got = tcc.encode_color_frame(pts, rgb, dtype=_TORCH[jdt], device="cpu", **kw)
    tol = _PSNR_TOL[jnp.dtype(jdt).name]
    for a, b in zip(got, want):
        assert (a.frame, a.step, a.n_voxels) == (b.frame, b.step, b.n_voxels)
        assert abs(a.bpp - b.bpp) <= 1e-3 * b.bpp
        assert abs(a.psnr - b.psnr) <= tol
        assert set(a.times) == set(b.times)
        assert a.csv_row().split(",")[:2] == b.csv_row().split(",")[:2]
    assert [p.psnr for p in got] == sorted(p.psnr for p in got)[::-1]


def test_csv_schema_and_helpers_match_jax():
    assert tcc.CSV_HEADER == jcc.CSV_HEADER
    times = {"RAHT_prelude_time": 0.25, "RAHT_transform_time": 1e-3, "Quant_time": 2.0,
             "Entropy_enc_time": 0.5, "Entropy_dec_time": 0.125, "Dequant_time": 1.5,
             "Coeff_reorder_dec_time": 0.5, "iRAHT_time": 3.0}
    args = dict(frame=3, step=2.5, bpp=1.234567891, psnr=40.5, n_voxels=10,
                stream_bytes=7, times=times)
    assert tcc.RDPoint(**args).csv_row() == jcc.RDPoint(**args).csv_row()
    a, b = np.arange(10.0), np.arange(10.0) + 0.5
    assert tcc.y_psnr_db(a, b) == jcc.y_psnr_db(a, b)
    assert tcc.y_psnr_db(a, a) == float("inf")
    assert (tcc.DEFAULT_DEPTH, tuple(tcc.DEFAULT_STEPS)) == \
        (jcc.DEFAULT_DEPTH, tuple(jcc.DEFAULT_STEPS))


def test_config_and_checks_match_jax(rng):
    from raht3dgs_tpu import config as jconf
    from raht3dgs_tpu.utils import checks as jchk
    from raht3dgs_tpu_torch import config as tconf
    from raht3dgs_tpu_torch.utils import checks as tchk

    assert vars(tconf.ColorCodecConfig()) == vars(jconf.ColorCodecConfig())
    rc = tconf.RuntimeConfig()
    assert (rc.platform, rc.dtype, rc.bucket) == ("cuda", "float64", 1 << 13)
    V = rng.uniform(0, 64, (300, 3))
    T, C = rng.uniform(0, 5, 300), rng.uniform(0, 5, 300)
    assert tchk.sanity_check_dc(T, C) == jchk.sanity_check_dc(T, C)
    for x, y in zip(tchk.is_frame_morton_ordered(V, 6), jchk.is_frame_morton_ordered(V, 6)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(tchk.block_indices(V, 8), jchk.block_indices(V, 8)):
        np.testing.assert_array_equal(x, y)
    v = rng.integers(-1000, 1000, 500)
    np.testing.assert_array_equal(tchk.signed_to_unsigned(v), jchk.signed_to_unsigned(v))
    u = tchk.signed_to_unsigned(v)
    np.testing.assert_array_equal(tchk.unsigned_to_signed(u), v)


# -- the CLIs --------------------------------------------------------------


def _raw_ply(tmp_path, n=3000):
    from raht3dgs_tpu_torch.io.ply import save_ply_ascii

    pts, rgb = synth.raw_surface_cloud(n, seed=3)
    path = tmp_path / "raw.ply"
    save_ply_ascii(path, pts.astype(np.float64), rgb.astype(int))
    return path


def _csv_rows(path):
    lines = path.read_text().strip().splitlines()
    return lines[0], [ln.split(",") for ln in lines[1:]]


def _run_both_clis(tmp_path, enc_extra, dec_extra, dtype="float64"):
    """encode_ply --voxelize with both packages on one raw PLY, then decode
    the JAX package's stream with both decode CLIs."""
    ply = _raw_ply(tmp_path)
    common = ["--input", str(ply), "--voxelize", "--depth", "6", "--steps", "2", "8",
              "--platform", "cpu", "--bucket", "512", "--dtype", dtype] + enc_extra
    for name, cli in (("j", jenc), ("t", tenc)):
        assert cli.main(common + ["--csv", str(tmp_path / f"{name}.csv"),
                                  "--save-streams", str(tmp_path / name)]) == 0
    # the voxelized positions, as an 8i PLY
    from raht3dgs_tpu_torch.io.ply import read_ply_8i, save_ply_ascii
    from raht3dgs_tpu_torch.ops.voxelize import voxelize

    V, C, _ = read_ply_8i(ply)
    res = voxelize(np.concatenate([V, C], axis=1), 6, device="cpu")
    pos = tmp_path / "pos.ply"
    save_ply_ascii(pos, res.positions[:int(res.nvox)].numpy().astype(float), width=63)
    stream = str(tmp_path / "j" / "frame0001_step2.r3tc")
    for name, cli in (("j", jdec), ("t", tdec)):
        assert cli.main(["--stream", stream, "--positions", str(pos),
                         "--output", str(tmp_path / f"rec_{name}.ply"),
                         "--platform", "cpu", "--bucket", "512", "--dtype", dtype]
                        + dec_extra) == 0
    return _csv_rows(tmp_path / "j.csv"), _csv_rows(tmp_path / "t.csv")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cli_encode_and_decode_match_jax_clis(tmp_path, no_jax_cache, dtype):
    (jh, jrows), (th, trows) = _run_both_clis(tmp_path, [], [], dtype)
    assert th == jh and len(trows) == len(jrows) == 2
    for a, b in zip(trows, jrows):
        assert a[:2] == b[:2]
        assert abs(float(a[2]) - float(b[2])) <= 1e-3 * float(b[2])
        assert abs(float(a[-1]) - float(b[-1])) <= _PSNR_TOL[dtype]
    for step in ("2", "8"):
        blob = (tmp_path / "t" / f"frame0001_step{step}.r3tc").read_bytes()
        assert JaxStream.from_bytes(blob).n_voxels == tp.FrameStream.from_bytes(blob).n_voxels
    assert (tmp_path / "rec_t.ply").read_bytes() == (tmp_path / "rec_j.ply").read_bytes()


@pytest.mark.parametrize("dec_extra", [["--progressive", "16"], ["--color-space", "raw"]])
def test_cli_decode_options_match_jax(tmp_path, no_jax_cache, capsys, dec_extra):
    _run_both_clis(tmp_path, ["--entropy-chunk", "64"], dec_extra)
    out = capsys.readouterr().out
    if dec_extra[0] == "--progressive":
        lines = [ln for ln in out.splitlines() if ln.startswith("progressive preview")]
        assert len(lines) == 2 and lines[0] == lines[1]
    else:
        a = np.load(str(tmp_path / "rec_t.ply") + ".attrs.npy")
        b = np.load(str(tmp_path / "rec_j.ply") + ".attrs.npy")
        assert np.abs(a - b).max() < 1e-9
    assert (tmp_path / "rec_t.ply").read_bytes() == (tmp_path / "rec_j.ply").read_bytes()


def test_cli_encode_ply_subprocess(tmp_path):
    ply = _raw_ply(tmp_path, n=2000)
    csv = tmp_path / "log.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "raht3dgs_tpu_torch.cli.encode_ply", "--input", str(ply),
         "--voxelize", "--depth", "6", "--steps", "1", "8", "--csv", str(csv),
         "--platform", "cpu", "--bucket", "512", "--save-streams", str(tmp_path / "s"),
         "--profile", str(tmp_path / "trace")],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "voxelized to" in proc.stdout
    header, rows = _csv_rows(csv)
    assert header == tcc.CSV_HEADER and len(rows) == 2
    assert sorted(p.name for p in (tmp_path / "s").glob("*.r3tc")) == \
        ["frame0001_step1.r3tc", "frame0001_step8.r3tc"]
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("cli,extra,item", [
    (tenc, ["--tiles", "3"], 15),
    (tenc, ["--target-bpp", "1.0"], 14),
    (tenc, ["--entropy", "rac"], 12),
    (tenc, ["--entropy", "auto"], 12),
    (tenc, ["--predict"], 13),
    (tenc, ["--code-geometry"], 12),
    (tdec, ["--lod", "3"], 15),
    (tdec, ["--roi", "0", "0", "0", "4", "4", "4"], 15),
    (tdec, ["--all-frames"], 15),
    (tdec, ["--frame-index", "2"], 15),
    (tdec, ["--geometry-lod", "2"], 12),
    (tdec, ["--color-space", "3dgs"], 11),
    (tdec, ["--no-positions"], 12),
])
def test_cli_unported_options_exit_naming_their_item(tmp_path, cli, extra, item):
    if cli is tenc:
        argv = ["--input", "x.ply", "--platform", "cpu"] + extra
    else:
        argv = ["--stream", "x.r3tc", "--output", str(tmp_path / "o.ply"),
                "--platform", "cpu"]
        argv += [] if extra == ["--no-positions"] else ["--positions", "p.ply"] + extra
    with pytest.raises(SystemExit, match=f"item {item}"):
        cli.main(argv)


@pytest.mark.parametrize("magic,item", [(b"R3TS", 15), (b"R3TT", 15)])
def test_cli_decode_containers_not_ported(tmp_path, magic, item):
    path = tmp_path / "s.bin"
    path.write_bytes(magic + b"\0" * 60)
    with pytest.raises(SystemExit, match=f"item {item}"):
        tdec.main(["--stream", str(path), "--positions", "p.ply",
                   "--output", str(tmp_path / "o.ply"), "--platform", "cpu"])
