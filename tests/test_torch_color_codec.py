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


# -- the RAC and auto entropy choices -----------------------------------------


def _noninteger_frames():
    """The golden cloud with non-integer colours in both packages (the f64
    byte-identity gate of ROADMAP queue A, item 6)."""
    pts, _, attrs = unique_voxel_cloud(np.random.default_rng(42), 600, 6)
    jf = jp.prepare_voxel_frame(pts, attrs, 6, bucket=1024)
    tf = tp.voxel_frame_from_arrays(np.array(jf.codes), np.array(jf.attributes),
                                    np.array(jf.weights), jf.n_voxels, 6, jf.vmin,
                                    jf.width, device="cpu")
    return jf, tf


@pytest.mark.parametrize("chunk", [0, 128])
@pytest.mark.parametrize("entropy", ["rac", "auto"])
def test_entropy_streams_byte_identical_to_jax(entropy, chunk):
    jf, tf = _noninteger_frames()
    jc = jp.AttributeCodec(6, entropy=entropy, chunk=chunk)
    tc = tp.AttributeCodec(6, entropy=entropy, chunk=chunk, device="cpu")
    steps = [1.0, 4.0, 16.0]
    want = [e.stream.to_bytes() for e in jc.encode_sweep(jf, steps)]
    got = [e.stream.to_bytes() for e in tc.encode_sweep(tf, steps)]
    assert got == want
    assert got == [tc.encode(tf, s).stream.to_bytes() for s in steps]
    for blob in got:
        ts, js = tp.FrameStream.from_bytes(blob), JaxStream.from_bytes(blob)
        assert ts.entropy_map is not None and any(ts.entropy_map)
        rec_t, _ = tc.decode(ts, tf.codes, tf.weights)
        rec_j, _ = jc.decode(js, jf.codes, jf.weights)
        assert np.abs(rec_t - np.asarray(rec_j)).max() < 1e-9
    if entropy == "auto":
        rl = [tp.FrameStream.from_bytes(e.stream.to_bytes()) for e in
              tp.AttributeCodec(6, chunk=chunk, device="cpu").encode_sweep(tf, steps)]
        for blob, r in zip(got, rl):
            a = tp.FrameStream.from_bytes(blob)
            assert all(len(x) <= len(y) for x, y in zip(a.channels, r.channels))


@pytest.mark.parametrize("chunk", [0, 128])
@pytest.mark.parametrize("entropy", ["rac", "auto"])
def test_progressive_entropy_decode_matches_jax(entropy, chunk):
    jf, tf = _noninteger_frames()
    blob = jp.AttributeCodec(6, entropy=entropy, chunk=chunk).encode(jf, 2.0).stream.to_bytes()
    for k in (1, 100, 599, 10_000):
        rec_t, _ = tp.AttributeCodec(6, device="cpu").decode_progressive(
            tp.FrameStream.from_bytes(blob), tf.codes, tf.weights, k)
        rec_j, _ = jp.AttributeCodec(6).decode_progressive(
            JaxStream.from_bytes(blob), jf.codes, jf.weights, k)
        assert np.abs(rec_t - np.asarray(rec_j)).max() < 1e-9
    s = tp.FrameStream.from_bytes(blob)
    assert tp.progressive_prefix_bytes(s, 100) == jp.progressive_prefix_bytes(
        JaxStream.from_bytes(blob), 100)


def test_auto_conditioned_channels_decode_in_both_packages():
    # channels 1-2 copy channel 0's zeros: the conditioned profile wins there
    rng = np.random.default_rng(9)
    pts, _, attrs = unique_voxel_cloud(rng, 1500, 7)
    attrs[:, 1] = attrs[:, 0] * 0.5 + rng.normal(0, 0.1, len(attrs))
    attrs[:, 2] = attrs[:, 0] * 0.25
    jf = jp.prepare_voxel_frame(pts, attrs, 7, bucket=2048)
    tf = tp.voxel_frame_from_arrays(np.array(jf.codes), np.array(jf.attributes),
                                    np.array(jf.weights), jf.n_voxels, 7, jf.vmin,
                                    jf.width, device="cpu")
    tc = tp.AttributeCodec(7, entropy="auto", device="cpu")
    blob = tc.encode(tf, 24.0).stream.to_bytes()
    s = tp.FrameStream.from_bytes(blob)
    from raht3dgs_tpu_torch.codec.rac import rac_stream_profile

    profiles = [rac_stream_profile(c) if r else -1 for c, r in zip(s.channels, s.entropy_map)]
    assert 1 in profiles[1:]
    assert blob == jp.AttributeCodec(7, entropy="auto").encode(jf, 24.0).stream.to_bytes()
    rec_t, _ = tc.decode(s, tf.codes, tf.weights)
    rec_j, _ = jp.AttributeCodec(7).decode(JaxStream.from_bytes(blob), jf.codes, jf.weights)
    assert np.abs(rec_t - np.asarray(rec_j)).max() < 1e-9
    # channel 0 is the conditioning source: a stream that claims otherwise raises
    bad = tp.FrameStream.from_bytes(blob)
    bad.channels = [s.channels[profiles.index(1)]] + list(s.channels[1:])
    bad.entropy_map = (True,) + tuple(s.entropy_map[1:])
    with pytest.raises(ValueError, match="channel 0"):
        tc.decode(bad, tf.codes, tf.weights)


@pytest.mark.parametrize("entropy", ["rac", "auto"])
def test_entropy_golden_stream_hash(entropy):
    # chip_smoke.py holds the card's bytes to the same pins
    import hashlib

    from raht3dgs_tpu_torch.codec.geometry import geometry_from_positions

    pts, attrs = synth.golden_fixture()
    frame = tp.prepare_voxel_frame(pts, attrs, synth.GOLDEN_DEPTH, bucket=synth.GOLDEN_BUCKET,
                                   device="cpu")
    stream = tp.AttributeCodec(synth.GOLDEN_DEPTH, entropy=entropy, device="cpu").encode(
        frame, steps=synth.GOLDEN_STEP).stream
    stream.geometry = geometry_from_positions(pts, synth.GOLDEN_DEPTH)
    blob = stream.to_bytes()
    assert hashlib.sha256(blob).hexdigest() == synth.GOLDEN_ENTROPY_SHA256[entropy]
    rec, _ = tp.AttributeCodec(synth.GOLDEN_DEPTH, device="cpu").decode(
        tp.FrameStream.from_bytes(blob), frame.codes, frame.weights)
    assert np.sqrt(np.mean((rec - attrs) ** 2)) <= synth.GOLDEN_STEP / 2


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


@pytest.mark.parametrize("dtype,dec_extra", [("float64", []), ("float32", []),
                                             ("float64", ["--progressive", "16"])])
def test_cli_predict_streams_and_decode_match_jax(tmp_path, no_jax_cache, capsys, dtype,
                                                  dec_extra):
    """encode_ply --predict (the host loop on the CPU in both packages):
    the same streams, CSV rows and decoded PLYs, full and progressive."""
    (jh, jrows), (th, trows) = _run_both_clis(tmp_path, ["--predict"], dec_extra, dtype)
    assert th == jh and len(trows) == len(jrows) == 2
    for a, b in zip(trows, jrows):
        assert a[:3] == b[:3]   # the same bytes; the reference YUV may differ in ulps
        assert abs(float(a[-1]) - float(b[-1])) <= _PSNR_TOL[dtype]
    for step in ("2", "8"):
        name = f"frame0001_step{step}.r3tc"
        blob = (tmp_path / "t" / name).read_bytes()
        assert blob == (tmp_path / "j" / name).read_bytes()
        assert tp.FrameStream.from_bytes(blob).predict
    assert (tmp_path / "rec_t.ply").read_bytes() == (tmp_path / "rec_j.ply").read_bytes()
    if dec_extra:
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("progressive preview")]
        assert len(lines) == 2 and lines[0] == lines[1]
    with pytest.raises(ValueError, match="predicted transform"):
        tcc.encode_color_frame(np.eye(3)[:2], np.ones((2, 3)), depth=3, steps=(1,),
                               decode=False,
                               codec=tp.AttributeCodec(3, predict=True, device="cpu"))


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


def _geometry_streams(tmp_path, entropy="auto"):
    """encode_ply --voxelize --code-geometry --entropy ENTROPY with both
    packages on one raw PLY, streams into ``j/`` and ``t/``."""
    ply = _raw_ply(tmp_path)
    common = ["--input", str(ply), "--voxelize", "--depth", "6", "--steps", "2", "8",
              "--platform", "cpu", "--bucket", "512", "--code-geometry",
              "--entropy", entropy]
    for name, cli in (("j", jenc), ("t", tenc)):
        assert cli.main(common + ["--csv", str(tmp_path / f"{name}.csv"),
                                  "--save-streams", str(tmp_path / name)]) == 0


@pytest.mark.parametrize("entropy", ["auto", "rac"])
def test_cli_code_geometry_streams_and_decode_match_jax(tmp_path, no_jax_cache, capsys,
                                                        entropy):
    _geometry_streams(tmp_path, entropy)
    out = capsys.readouterr().out
    geo = [ln for ln in out.splitlines() if "bits/voxel (lossless)" in ln]
    assert len(geo) == 2 and geo[0] == geo[1]
    (jh, jrows), (th, trows) = _csv_rows(tmp_path / "j.csv"), _csv_rows(tmp_path / "t.csv")
    for a, b in zip(trows, jrows):
        assert a[:2] == b[:2] and abs(float(a[2]) - float(b[2])) <= 1e-3 * float(b[2])
    for step in ("2", "8"):
        name = f"frame0001_step{step}.r3tc"
        ts = tp.FrameStream.from_bytes((tmp_path / "t" / name).read_bytes())
        js = JaxStream.from_bytes((tmp_path / "j" / name).read_bytes())
        assert ts.geometry == js.geometry and ts.geometry[0] == 0   # < 16384 voxels
        assert ts.entropy_map is not None and any(ts.entropy_map)
    # the JAX stream without --positions through both decoders, and with them
    stream = str(tmp_path / "j" / "frame0001_step2.r3tc")
    for name, cli in (("j", jdec), ("t", tdec)):
        assert cli.main(["--stream", stream, "--output", str(tmp_path / f"self_{name}.ply"),
                         "--platform", "cpu", "--bucket", "512"]) == 0
    assert (tmp_path / "self_t.ply").read_bytes() == (tmp_path / "self_j.ply").read_bytes()
    from raht3dgs_tpu_torch.codec.geometry import positions_from_geometry
    from raht3dgs_tpu_torch.io.ply import read_ply_8i, save_ply_ascii

    js = JaxStream.from_bytes(open(stream, "rb").read())
    V = positions_from_geometry(js.geometry, 6, js.n_voxels, device="cpu")
    pos = tmp_path / "pos.ply"
    perm = np.random.default_rng(0).permutation(len(V))
    save_ply_ascii(pos, V[perm].astype(float), width=63)
    assert tdec.main(["--stream", stream, "--positions", str(pos), "--output",
                      str(tmp_path / "with.ply"), "--platform", "cpu", "--bucket", "512"]) == 0
    a, ca, _ = read_ply_8i(tmp_path / "self_t.ply")
    b, cb, _ = read_ply_8i(tmp_path / "with.ply")
    back = np.argsort(perm)
    assert np.array_equal(a, V.astype(float)) and np.array_equal(b[back], a)
    assert np.array_equal(cb[back], ca)


@pytest.fixture(scope="module")
def auto_geometry_dir(tmp_path_factory):
    """The two packages' --code-geometry --entropy auto streams, made once
    for the decode tests below."""
    tmp = tmp_path_factory.mktemp("geometry")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAHT3DGS_COMPILE_CACHE", "")
        _geometry_streams(tmp)
    return tmp


@pytest.mark.parametrize("level", [1, 3, 6])
def test_cli_geometry_lod_matches_jax(tmp_path, auto_geometry_dir, no_jax_cache, capsys,
                                      level):
    stream = str(auto_geometry_dir / "t" / "frame0001_step8.r3tc")
    for name, cli in (("j", jdec), ("t", tdec)):
        assert cli.main(["--stream", stream, "--output", str(tmp_path / f"lod_{name}.ply"),
                         "--geometry-lod", str(level), "--platform", "cpu"]) == 0
    assert (tmp_path / "lod_t.ply").read_bytes() == (tmp_path / "lod_j.ply").read_bytes()
    lines = [ln.split(" -> ")[0] for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("geometry LOD")]
    assert len(lines) == 2 and lines[0] == lines[1]


@pytest.mark.parametrize("case", ["moved_voxel", "no_geometry", "temporal_geometry",
                                  "lod_out_of_range", "lod_with_progressive",
                                  "lod_no_geometry"])
def test_cli_decode_geometry_refusals_match_jax(tmp_path, auto_geometry_dir, no_jax_cache,
                                                case):
    from raht3dgs_tpu_torch.codec.geometry import encode_geometry, positions_from_geometry
    from raht3dgs_tpu_torch.io.ply import save_ply_ascii

    src = auto_geometry_dir / "t" / "frame0001_step8.r3tc"
    s = tp.FrameStream.from_bytes(src.read_bytes())
    V = positions_from_geometry(s.geometry, 6, s.n_voxels, device="cpu")
    argv = ["--output", str(tmp_path / "o.ply"), "--platform", "cpu", "--bucket", "512"]
    match = {"moved_voxel": "does not match the geometry", "no_geometry": "no geometry",
             "temporal_geometry": "temporal geometry", "lod_out_of_range": "must be in",
             "lod_with_progressive": "positions-only", "lod_no_geometry": "needs a stream"}
    if case == "moved_voxel":
        free = next(x for x in range(64) if not (V == [x, 0, 0]).all(1).any())
        V = V.copy()
        V[0] = [free, 0, 0]
        save_ply_ascii(tmp_path / "wrong.ply", V.astype(float), width=63)
        argv += ["--positions", str(tmp_path / "wrong.ply")]
    elif case in ("no_geometry", "lod_no_geometry"):
        s.geometry = None
        argv += ["--geometry-lod", "2"] if case == "lod_no_geometry" else []
    elif case == "temporal_geometry":
        codes = np.sort(synth.morton_codes_np(V, 6))
        s.geometry = encode_geometry(codes, 6, prev_codes=codes[::2])
    else:
        argv += ["--geometry-lod", "7" if case == "lod_out_of_range" else "2"]
        argv += ["--progressive", "5"] if case == "lod_with_progressive" else []
    path = tmp_path / "case.r3tc"
    path.write_bytes(s.to_bytes())
    for cli in (tdec, jdec):
        with pytest.raises(SystemExit, match=match[case]):
            cli.main(["--stream", str(path)] + argv)


def _gs_stream(tmp_path):
    """A 56-channel float64 stream at J=5 and its compressed-3DGS positions
    PLY (integer voxel coordinates, voxel size and vmin in the header)."""
    from raht3dgs_tpu_torch.io.ply import save_ply_3dgs

    rng = np.random.default_rng(4)
    pts, _, _ = unique_voxel_cloud(rng, 300, 5)
    A = np.concatenate([rng.normal(0, 1, (len(pts), 4)), rng.uniform(0.01, 0.2, (len(pts), 3)),
                        rng.uniform(0.1, 0.9, (len(pts), 1)),
                        rng.normal(0, 0.5, (len(pts), 48))], axis=1)
    frame = tp.prepare_voxel_frame(pts, A, 5, bucket=512, device="cpu")
    stream = tp.AttributeCodec(5, device="cpu").encode(frame, 0.05).stream
    (tmp_path / "gs.r3tc").write_bytes(stream.to_bytes())
    save_ply_3dgs(tmp_path / "gs_pos.ply", means=pts.astype(float), quats=A[:, :4],
                  scales=A[:, 4:7], opacities=A[:, 7], colors=A[:, 8:], voxel_size=0.01,
                  vmin=np.array([0.5, -1.0, 2.0]))
    return tmp_path / "gs.r3tc", tmp_path / "gs_pos.ply"


def _geometry_sequence(auto_geometry_dir, tmp_path):
    """An all-intra R3TS of three self-contained streams (the port's
    --code-geometry streams of one frame at steps 2, 8 and 2)."""
    from raht3dgs_tpu_torch.codec.bitstream import write_sequence

    t = auto_geometry_dir / "t"
    blobs = [(t / f"frame0001_step{s}.r3tc").read_bytes() for s in (2, 8, 2)]
    write_sequence(tmp_path / "s.r3ts", blobs)
    return tmp_path / "s.r3ts"


def _same_3dgs(a, b):
    from raht3dgs_tpu_torch.io.ply import read_compressed_3dgs_ply

    Va, Aa, sa, va = read_compressed_3dgs_ply(a)
    Vb, Ab, sb, vb = read_compressed_3dgs_ply(b)
    return (np.array_equal(Va, Vb) and sa == sb and np.array_equal(va, vb)
            and float(np.abs(Aa - Ab).max()) <= 1e-6 * max(1.0, float(np.abs(Ab).max())))


@pytest.mark.parametrize("cli,extra,item", [
    (tenc, ["--tiles", "3"], 15),
    (tenc, ["--tiles", "3", "--target-bpp", "1.0"], 15),   # --tiles is checked first
    (tdec, ["--lod", "3"], None),
    (tdec, ["--roi", "0", "0", "0", "4", "4", "4"], 15),
    (tdec, ["--all-frames"], None),
    (tdec, ["--frame-index", "2"], None),
    (tdec, ["--color-space", "3dgs", "--lod", "2"], None),
])
def test_cli_unported_options_exit_naming_their_item(tmp_path, auto_geometry_dir, no_jax_cache,
                                                     cli, extra, item):
    """The options still to come exit naming their ROADMAP item; those
    ported since (item None) write the JAX decode CLI's output: ``--lod``
    on a colour stream and on a 3DGS one, ``--all-frames`` and
    ``--frame-index`` on a sequence of self-contained streams."""
    if item is not None:
        if cli is tenc:
            argv = ["--input", "x.ply", "--platform", "cpu"] + extra
        else:
            argv = ["--stream", "x.r3tc", "--output", str(tmp_path / "o.ply"),
                    "--platform", "cpu", "--positions", "p.ply"] + extra
        with pytest.raises(SystemExit, match=f"item {item}"):
            cli.main(argv)
        return
    if "--color-space" in extra:
        stream, pos = _gs_stream(tmp_path)
        src = ["--stream", str(stream), "--positions", str(pos)]
    elif "--lod" in extra:
        src = ["--stream", str(auto_geometry_dir / "t" / "frame0001_step8.r3tc")]
    else:
        src = ["--stream", str(_geometry_sequence(auto_geometry_dir, tmp_path))]
    for name, dec in (("j", jdec), ("t", tdec)):
        out = tmp_path / name / ("o_{i}.ply" if "--all-frames" in extra else "o.ply")
        assert dec.main(src + ["--output", str(out), "--platform", "cpu", "--bucket", "512"]
                        + extra) == 0
    outs = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert outs == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert len(outs) == {"--all-frames": 3}.get(extra[0], 1 + ("--lod" in extra))
    for name in outs:
        got, want = tmp_path / "t" / name, tmp_path / "j" / name
        if name.endswith(".npy"):
            assert np.array_equal(np.load(got), np.load(want))
        elif "--color-space" in extra:
            assert _same_3dgs(got, want)
        else:
            assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("magic,item", [(b"R3TS", None), (b"R3TT", 15)])
def test_cli_decode_containers_not_ported(tmp_path, auto_geometry_dir, no_jax_cache, magic,
                                          item):
    """R3TT input exits naming its item; an R3TS sequence (ported since)
    decodes its frame 0 as the JAX decode CLI does, with positions given."""
    if item is not None:
        path = tmp_path / "s.bin"
        path.write_bytes(magic + b"\0" * 60)
        with pytest.raises(SystemExit, match=f"item {item}"):
            tdec.main(["--stream", str(path), "--positions", "p.ply",
                       "--output", str(tmp_path / "o.ply"), "--platform", "cpu"])
        return
    from raht3dgs_tpu_torch.codec.geometry import positions_from_geometry
    from raht3dgs_tpu_torch.io.ply import save_ply_ascii

    seq = _geometry_sequence(auto_geometry_dir, tmp_path)
    s = tp.FrameStream.from_bytes((auto_geometry_dir / "t" / "frame0001_step2.r3tc")
                                  .read_bytes())
    V = positions_from_geometry(s.geometry, 6, s.n_voxels, device="cpu")
    save_ply_ascii(tmp_path / "p.ply", V[::-1].astype(float), width=63)
    for name, dec in (("j", jdec), ("t", tdec)):
        assert dec.main(["--stream", str(seq), "--positions", str(tmp_path / "p.ply"),
                         "--output", str(tmp_path / f"{name}.ply"), "--platform", "cpu",
                         "--bucket", "512"]) == 0
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
