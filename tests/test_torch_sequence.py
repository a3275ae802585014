"""The port's R3TS sequence container, ``MemBuf`` and level-of-detail decode
against the JAX package's, on the CPU.

The container and ``MemBuf`` are host byte formats: the same blobs give the
same bytes, each package reads the other's file, and every reader error has
the JAX reader's message. ``lod_prefix_count`` is integer arithmetic and
must be equal at every depth. ``decode_lod`` positions and cell weights are
exact; attributes agree within 1e-9 (float64) / 1e-5 (float32) of the
attribute range, the transform's float rounding apart."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raht3dgs_tpu.codec import bitstream as jbs, rlgr as jrlgr
from raht3dgs_tpu.models import pipeline as jp
from raht3dgs_tpu.ops.prelude import morton_codes_np
from raht3dgs_tpu_torch.codec import MemBuf, bitstream as tbs
from raht3dgs_tpu_torch.models import pipeline as tp

_TORCH = {jnp.float64: torch.float64, jnp.float32: torch.float32}
LOD_TOL = {jnp.float64: 1e-9, jnp.float32: 1e-5}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(rng, n=1500, depth=7, dtype=jnp.float64, bucket=512):
    """A smooth non-integer colour frame in both packages."""
    pts = rng.integers(0, 2**depth, (3 * n, 3))
    _, first = np.unique(morton_codes_np(pts, depth), return_index=True)
    V = pts[np.sort(first)][:n]
    attrs = V @ rng.uniform(0.3, 1.5, (3, 3)) + rng.normal(0, 2.0, (len(V), 3)) + 0.37
    jf = jp.prepare_voxel_frame(V.astype(np.int64), attrs, depth, bucket=bucket, dtype=dtype)
    tf = tp.voxel_frame_from_arrays(np.array(jf.codes), np.array(jf.attributes),
                                    np.array(jf.weights), jf.n_voxels, jf.depth, jf.vmin,
                                    jf.width, device="cpu")
    return jf, tf


@pytest.fixture(scope="module")
def streams():
    """Three f64 frame streams of the port (one with a geometry section)."""
    rng = np.random.default_rng(5)
    codec = tp.AttributeCodec(7, device="cpu")
    out = []
    for k, n in enumerate((900, 1200, 700)):
        _, tf = _frame(rng, n)
        s = codec.encode(tf, 4.0 + k).stream
        if k == 1:
            from raht3dgs_tpu_torch.codec.geometry import encode_geometry

            s.geometry = encode_geometry(tf.codes[:tf.n_voxels].numpy(), 7)
        out.append(s)
    return out


@pytest.mark.parametrize("raw", [False, True], ids=["framestreams", "raw_bytes"])
def test_write_sequence_bytes_equal_jax(tmp_path, streams, raw):
    blobs = [s.to_bytes() for s in streams]
    items = blobs if raw else streams
    jitems = blobs if raw else [jbs.FrameStream.from_bytes(b) for b in blobs]
    nt = tbs.write_sequence(tmp_path / "t.r3ts", items)
    nj = jbs.write_sequence(tmp_path / "j.r3ts", jitems)
    assert nt == nj == (tmp_path / "t.r3ts").stat().st_size
    assert (tmp_path / "t.r3ts").read_bytes() == (tmp_path / "j.r3ts").read_bytes()
    assert (tbs.SEQ_MAGIC, tbs.SEQ_VERSION) == (jbs.SEQ_MAGIC, jbs.SEQ_VERSION)


def test_sequence_files_read_by_the_other_package(tmp_path, streams):
    tbs.write_sequence(tmp_path / "t.r3ts", streams)
    jbs.write_sequence(tmp_path / "j.r3ts",
                       [jbs.FrameStream.from_bytes(s.to_bytes()) for s in streams])
    for path in ("t.r3ts", "j.r3ts"):
        tr, jr = tbs.SequenceReader(tmp_path / path), jbs.SequenceReader(tmp_path / path)
        assert len(tr) == len(jr) == len(streams)
        for i, s in enumerate(streams):
            assert tr.frame_bytes(i) == jr.frame_bytes(i) == s.to_bytes()
            assert tr.frame(i).to_bytes() == jr.frame(i).to_bytes()
        assert [f.to_bytes() for f in tr] == [f.to_bytes() for f in jr]
        for reader in (tr, jr):
            with pytest.raises(IndexError, match="out of range"):
                reader.frame_bytes(len(streams))
    assert tbs.SequenceReader(tmp_path / "t.r3ts").frame(1).geometry is not None
    tbs.write_sequence(tmp_path / "e.r3ts", [])
    assert len(tbs.SequenceReader(tmp_path / "e.r3ts")) == 0


def _corrupt(good: bytes, case: str) -> bytes:
    n = struct.unpack("<I", good[8:12])[0]
    table = 12 + 8 * (n + 1)
    if case == "truncated_header":
        return good[:7]
    if case == "bad_magic":
        return b"R3TX" + good[4:]
    if case == "wrong_version":
        return good[:4] + bytes([2]) + good[5:]
    if case == "cut_offset_table":
        return good[:table - 3]
    if case == "decreasing_offsets":
        offs = list(struct.unpack(f"<{n + 1}Q", good[12:table]))
        offs[1], offs[2] = offs[2], offs[1]
        return good[:12] + struct.pack(f"<{n + 1}Q", *offs) + good[table:]
    return good[:-5]  # frames past the end of the file


@pytest.mark.parametrize("case", ["truncated_header", "bad_magic", "wrong_version",
                                  "cut_offset_table", "decreasing_offsets",
                                  "frames_past_end"])
def test_reader_errors_match_jax(tmp_path, streams, case):
    tbs.write_sequence(tmp_path / "good.r3ts", streams)
    bad = tmp_path / "bad.r3ts"
    bad.write_bytes(_corrupt((tmp_path / "good.r3ts").read_bytes(), case))
    with pytest.raises(ValueError) as want:
        jbs.SequenceReader(bad)
    with pytest.raises(ValueError) as got:
        tbs.SequenceReader(bad)
    assert str(got.value) == str(want.value)


def test_membuf_round_trips_and_matches_jax():
    rng = np.random.default_rng(2)
    vals = (rng.geometric(0.3, 4000) * rng.choice([-1, 0, 1], 4000)).tolist()
    for signed in (1, 0):
        v = [abs(x) for x in vals] if not signed else vals
        tw, jw = MemBuf(), jrlgr.MemBuf()
        tw.rlgrWrite(v, signed)
        jw.rlgrWrite(v, signed)
        assert tw.get_buffer() == jw.get_buffer()
        assert tw.buffer_size() == len(tw.get_buffer())
        _, back = MemBuf(tw.get_buffer()).rlgrRead(len(v), signed)
        assert back == v
        tw.close()
    for value, k in ((0, 0), (5, 1), (37, 3), (1000, 4), (123456, 7)):
        tw, jw = MemBuf(), jrlgr.MemBuf()
        tw.grWrite(value, k)
        jw.grWrite(value, k)
        assert tw.get_buffer() == jw.get_buffer()
        assert MemBuf(tw.get_buffer()).grRead(k) == jrlgr.MemBuf(jw.get_buffer()).grRead(k) \
            == value
    assert MemBuf().buffer_size() == 0


@pytest.mark.parametrize("depth,n", [(7, 1500), (12, 900)])
def test_lod_prefix_count_matches_jax(depth, n):
    rng = np.random.default_rng(depth)
    jf, _ = _frame(rng, n, depth)
    codes = np.asarray(jf.codes)[:jf.n_voxels]
    for lod in range(1, depth + 1):
        assert tp.lod_prefix_count(codes, depth, lod) == jp.lod_prefix_count(codes, depth, lod)
    assert tp.lod_prefix_count(codes[:1], depth, 2) == 1
    x = rng.integers(1, 2**62, 1000).astype(np.uint64)
    assert np.array_equal(tp._msb_np(x), jp._msb_np(x))
    for bad in (0, depth + 1):
        with pytest.raises(ValueError, match="lod_depth must be in") as e:
            tp.lod_prefix_count(codes, depth, bad)
        with pytest.raises(ValueError) as w:
            jp.lod_prefix_count(codes, depth, bad)
        assert str(e.value) == str(w.value)


@pytest.mark.parametrize("predict", [False, True], ids=["plain", "predicted"])
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_decode_lod_matches_jax(dtype, predict):
    rng = np.random.default_rng(7)
    jf, tf = _frame(rng, 1500, 7, dtype=dtype)
    tc = tp.AttributeCodec(7, dtype=_TORCH[dtype], predict=predict, device="cpu")
    jc = jp.AttributeCodec(7, dtype=dtype, predict=predict)
    stream = tc.encode(tf, 2.0).stream
    js = jbs.FrameStream.from_bytes(stream.to_bytes())
    span = float(np.ptp(np.asarray(jf.attributes)[:jf.n_voxels]))
    for lod in (1, 3, 5, 7):
        pt, at, wt = tc.decode_lod(stream, tf.codes, tf.weights, lod)
        pj, aj, wj = jc.decode_lod(js, jf.codes, jf.weights, lod)
        assert np.array_equal(pt, np.asarray(pj)) and pt.dtype == np.asarray(pj).dtype
        assert np.array_equal(wt, wj)
        assert at.shape == aj.shape and len(pt) == tp.lod_prefix_count(
            tf.codes[:tf.n_voxels].numpy(), 7, lod)
        assert float(np.abs(at - aj).max()) <= LOD_TOL[dtype] * span, lod
    # the finest level is the full decode, one row a voxel
    full, _ = tc.decode(stream, tf.codes, tf.weights)
    _, at, _ = tc.decode_lod(stream, tf.codes, tf.weights, 7)
    assert float(np.abs(at - full).max()) <= LOD_TOL[dtype] * span


def test_decode_lod_refuses_other_orders():
    rng = np.random.default_rng(8)
    jf, tf = _frame(rng, 600, 6)
    tc = tp.AttributeCodec(6, order_mode="weight_desc", device="cpu")
    stream = tc.encode(tf, 4.0).stream
    with pytest.raises(ValueError, match="RA-GFT") as got:
        tc.decode_lod(stream, tf.codes, tf.weights, 3)
    with pytest.raises(ValueError) as want:
        jp.AttributeCodec(6, order_mode="weight_desc").decode_lod(
            jbs.FrameStream.from_bytes(stream.to_bytes()), jf.codes, jf.weights, 3)
    assert str(got.value) == str(want.value)
