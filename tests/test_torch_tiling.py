"""The port's tiled frames (``models/tiling.py``, ``.r3tt`` v1 and v2)
against the JAX package's, on the CPU.

The container is a host byte format around per-tile codec streams: on
float64 non-integer content the same frame gives the same bytes in both
packages (the tile streams included), each package reads and decodes the
other's blob, and every reader and encoder error carries the JAX message.
Float32 tiles are held to ROADMAP queue A item 6's gate: the same tiling
and tile sizes, and cross-decodes within 1e-3. Decoded positions are
exact, float64 attributes within 1e-9."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raht3dgs_tpu.models import pipeline as jp, tiling as jt
from raht3dgs_tpu.ops.prelude import morton_codes_np
from raht3dgs_tpu_torch.models import pipeline as tp, tiling as tt

DEPTH = 7
F64_TOL = 1e-9
F32_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def content():
    """~2 000 unique voxels at J=7 with smooth non-integer colours."""
    rng = np.random.default_rng(11)
    pts = rng.integers(0, 2**DEPTH, (5000, 3))
    _, first = np.unique(morton_codes_np(pts, DEPTH), return_index=True)
    V = pts[np.sort(first)][:2000]
    attrs = V @ rng.uniform(0.3, 1.5, (3, 3)) + rng.normal(0, 2.0, (len(V), 3)) + 0.37
    return V, attrs


def _both_blobs(content, brick_depth=2, step=4.0, dtype=jnp.float64, **kw):
    V, attrs = content
    codec_kw = {k: kw.pop(k) for k in ("entropy", "predict", "predict_impl", "quant_mode",
                                       "chunk") if k in kw}
    jc = jp.AttributeCodec(DEPTH, dtype=dtype, **codec_kw)
    tc = tp.AttributeCodec(DEPTH, dtype={jnp.float64: torch.float64,
                                         jnp.float32: torch.float32}[dtype],
                           device="cpu", **codec_kw)
    jb, js = jt.encode_tiled_frame(V, attrs, DEPTH, brick_depth, jc, step, **kw)
    tb, ts = tt.encode_tiled_frame(V, attrs, DEPTH, brick_depth, tc, step, **kw)
    return jb, js, tb, ts


def _morton_order(V):
    return np.argsort(morton_codes_np(V.astype(np.int64), DEPTH), kind="stable")


CASES = {
    "v1": dict(version=1),
    "v1_geometry": dict(version=1, code_geometry=True),
    "v2": dict(version=2),
    "v2_geometry": dict(version=2, code_geometry=True),
    "v2_bricks1": dict(brick_depth=1),
    "v2_bricks3_geometry": dict(brick_depth=3, code_geometry=True),
    "v2_rac": dict(entropy="rac", code_geometry=True),
    "v1_auto": dict(version=1, entropy="auto"),
    "v2_predict": dict(predict=True, predict_impl="host", code_geometry=True),
    "v2_deadzone_chunked": dict(quant_mode="deadzone", chunk=256),
    "v2_step_vector": dict(step=np.array([2.0, 5.0, 7.5])),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tiled_bytes_match_jax(content, case):
    """Float64, non-integer colours: the JAX writer's bytes and tile stats;
    both packages decode both blobs to the same positions and attributes."""
    kw = dict(CASES[case])
    jb, js, tb, ts = _both_blobs(content, **kw)
    assert tb == jb and ts == js
    if kw.get("entropy") == "rac":
        assert tt.TiledReader(tb)._flags & tt._TFLAG_EMAP
    if kw.get("predict"):
        r = tt.TiledReader(tb)
        assert r._flags & tt._TFLAG_PREDICT and all(r.tile(i).predict for i in range(len(r)))
    V, attrs = content
    pos = None if kw.get("code_geometry") else V
    Vj, Aj = jt.decode_tiled_frame(tb, positions=pos)
    Vt, At = tt.decode_tiled_frame(jb, positions=pos, device="cpu")
    np.testing.assert_array_equal(Vt, Vj)
    np.testing.assert_array_equal(Vt, V[_morton_order(V)])
    assert float(np.abs(At - Aj).max()) <= F64_TOL
    assert float(np.abs(At - attrs[_morton_order(V)]).max()) < 2 * 4.0 * 3


@pytest.mark.parametrize("version", [1, 2])
def test_f32_tiles_within_the_gate(content, version):
    """Float32 tiles: the same bricks and voxel counts, and each package
    decodes the other's blob within 1e-3 of its own decode."""
    jb, js, tb, ts = _both_blobs(content, dtype=jnp.float32, version=version,
                                 code_geometry=True)
    assert [(k, n) for k, n, _ in ts] == [(k, n) for k, n, _ in js]
    rj, rt = tt.TiledReader(jb), tt.TiledReader(tb)
    np.testing.assert_array_equal(rj.keys, rt.keys)
    assert rt.meta.dtype32 and rj.meta.dtype32
    for blob in (jb, tb):
        Vj, Aj = jt.decode_tiled_frame(blob)
        Vt, At = tt.decode_tiled_frame(blob, device="cpu")
        np.testing.assert_array_equal(Vt, Vj)
        assert At.dtype == np.float32
        assert float(np.abs(At - Aj).max()) <= F32_TOL


@pytest.mark.parametrize("case", ["v1", "v2_geometry", "v2_rac", "v2_predict"])
def test_reader_fields_match_jax(content, case):
    """keys, fixed_bytes, n_voxels, meta and every tile stream, read by both
    readers from the same blob."""
    kw = dict(CASES[case])
    _, _, tb, _ = _both_blobs(content, **kw)
    rj, rt = jt.TiledReader(tb), tt.TiledReader(tb)
    assert (rt.version, rt.depth, rt.brick_depth, len(rt)) == \
        (rj.version, rj.depth, rj.brick_depth, len(rj))
    np.testing.assert_array_equal(rt.keys, rj.keys)
    assert rt.fixed_bytes == rj.fixed_bytes and rt.n_voxels == rj.n_voxels
    assert rt.meta.to_bytes() == rj.meta.to_bytes()
    assert rt.geometry == rj.geometry
    for i in range(len(rt)):
        assert rt.tile_bytes(i) == rj.tile_bytes(i)
        st, sj = rt.tile(i), rj.tile(i)
        assert st.to_bytes() == sj.to_bytes()
        assert (st.entropy_map, st.predict, st.predict_mask) == \
            (sj.entropy_map, sj.predict, sj.predict_mask)
    with pytest.raises(IndexError, match="out of range"):
        rt.tile_bytes(len(rt))


@pytest.mark.parametrize("brick_depth", [1, 2, 3])
def test_select_roi_and_brick_box_match_jax(content, brick_depth):
    _, _, tb, _ = _both_blobs(content, brick_depth=brick_depth, code_geometry=True)
    rj, rt = jt.TiledReader(tb), tt.TiledReader(tb)
    for k in rt.keys:
        for a, b in zip(tt.brick_box(int(k), DEPTH, brick_depth),
                        jt.brick_box(int(k), DEPTH, brick_depth)):
            np.testing.assert_array_equal(a, np.asarray(b))
    rng = np.random.default_rng(brick_depth)
    boxes = [((0, 0, 0), (128, 128, 128)), ((0, 0, 0), (1, 1, 1)), ((64, 0, 32), (100, 128, 60)),
             ((127, 127, 127), (200, 200, 200)), ((130, 0, 0), (140, 5, 5))]
    for _ in range(8):
        lo = rng.integers(0, 120, 3)
        boxes.append((lo, lo + rng.integers(1, 60, 3)))
    for lo, hi in boxes:
        assert rt.select_roi(lo, hi) == rj.select_roi(lo, hi)


def test_decode_roi_and_positions_match_jax(content):
    """ROI decodes (with the geometry and with ``positions=``) of a port blob
    and of a JAX blob equal the JAX decode, and clip the full decode."""
    V, _ = content
    jb_g, _, tb_g, _ = _both_blobs(content, code_geometry=True)
    jb_p, _, tb_p, _ = _both_blobs(content, version=1)
    full_V, full_A = tt.decode_tiled_frame(tb_g, device="cpu")
    for lo, hi in (((0, 0, 0), (64, 64, 64)), ((10, 40, 3), (100, 128, 77))):
        keep = np.all((full_V >= np.asarray(lo)) & (full_V < np.asarray(hi)), axis=1)
        for blob, pos in ((tb_g, None), (jb_g, None), (tb_p, V), (jb_p, V)):
            Vt, At = tt.decode_tiled_frame(blob, roi=(lo, hi), positions=pos, device="cpu")
            Vj, Aj = jt.decode_tiled_frame(blob, roi=(lo, hi), positions=pos)
            np.testing.assert_array_equal(Vt, Vj)
            assert float(np.abs(At - Aj).max()) <= F64_TOL
            np.testing.assert_array_equal(Vt, full_V[keep])
            assert float(np.abs(At - full_A[keep]).max()) <= F64_TOL


def _messages(fn_j, fn_t):
    """Both calls fail: (JAX error, port error) as (type name, message)."""
    out = []
    for fn in (fn_j, fn_t):
        with pytest.raises(Exception) as e:
            fn()
        out.append((type(e.value).__name__, str(e.value)))
    return out


def _read_all(mod):
    def run(blob):
        r = mod.TiledReader(blob)
        for i in range(len(r)):
            r.tile(i)
    return run


def _mutate(blob, off, fmt, value):
    b = bytearray(blob)
    struct.pack_into(fmt, b, off, value)
    return bytes(b)


def test_guards_match_jax(content):
    """The encoder's and reader's errors of JAX ``tests/test_tiling.py::
    test_guards`` and the encoder's other refusals, with the JAX messages."""
    V, attrs = content
    jc = jp.AttributeCodec(DEPTH)
    tc = tp.AttributeCodec(DEPTH, device="cpu")
    _, _, blob, _ = _both_blobs(content, code_geometry=True)
    Vdup = np.concatenate([V[:5], V[:1]])
    calls = [
        lambda m, c: m.encode_tiled_frame(V, attrs, DEPTH, DEPTH, c, 8.0),
        lambda m, c: m.encode_tiled_frame(V, attrs, DEPTH, 0, c, 8.0),
        lambda m, c: m.encode_tiled_frame(V, attrs, DEPTH, 2, c, 8.0, version=3),
        lambda m, c: m.encode_tiled_frame(Vdup, attrs[:6], DEPTH, 2, c, 8.0),
        lambda m, c: m.TiledReader(b"XXXX" + blob[4:]),
        lambda m, c: m.TiledReader(blob[:40]),
        lambda m, c: m.TiledReader(blob).select_roi((0, 0), (1, 1)),
        lambda m, c: m.TiledReader(blob).select_roi((0, 0, 0), (0, 1, 1)),
    ]
    for call in calls:
        (tj, mj), (tt_, mt) = _messages(lambda: call(jt, jc), lambda: call(tt, tc))
        assert (tt_, mt) == (tj, mj)


def _decode_cpu(blob, **kw):
    return tt.decode_tiled_frame(blob, device="cpu", **kw)


def test_guard_messages_of_the_decoder(content):
    """An empty ROI, a ROI that meets no brick, tiles without geometry and
    positions that do not cover a brick: the JAX decoder's messages."""
    V, _ = content
    _, _, blob, _ = _both_blobs(content, code_geometry=True)
    _, _, blob_ng, _ = _both_blobs(content)
    for kw, b in ((dict(roi=((0, 0, 0), (0, 1, 1))), blob),
                  (dict(roi=((256, 256, 256), (257, 257, 257))), blob),
                  ({}, blob_ng), (dict(positions=V[:-40]), blob_ng)):
        (tj, mj), (tt_, mt) = _messages(lambda: jt.decode_tiled_frame(b, **kw),
                                        lambda: _decode_cpu(b, **kw))
        assert (tt_, mt) == (tj, mj)


def test_corrupt_containers_fail_with_jax_messages(content):
    """``test_v2_corruption_fails_cleanly`` and each reader check: a short
    header, bad magic, a wrong version, a bad brick depth, a cut index,
    decreasing offsets, offsets past the end, keys not ascending, a cut
    geometry or template section, a template of another depth, a first
    offset that does not follow the sections, a truncated tile body and a
    channel-length mismatch."""
    _, _, blob, _ = _both_blobs(content, code_geometry=True)
    _, _, blob_ng, _ = _both_blobs(content)
    r = tt.TiledReader(blob)
    n = len(r)
    off0 = 12 + 8 * n
    sec = off0 + 8 * (n + 1)
    first = r._offsets[0]
    r_ng = tt.TiledReader(blob_ng)
    sec_ng = 12 + 8 * len(r_ng) + 8 * (len(r_ng) + 1)
    cases = {
        "short": blob[:8],
        "magic": b"XXXX" + blob[4:],
        "version": blob[:4] + bytes([3]) + blob[5:],
        "brick_depth": blob[:6] + bytes([DEPTH]) + blob[7:],
        "index": blob[:12 + 8 * n + 8],
        "offsets_decrease": _mutate(blob, off0 + 8, "<Q", first - 1),
        "offsets_past_end": blob[:-3],
        "keys": _mutate(blob, 12 + 8, "<q", int(r.keys[0])),
        "geometry_cut": _mutate(blob, sec, "<I", 1 << 30),
        "template_cut": _mutate(blob_ng, sec_ng, "<I", 1 << 30),
        "header_sections": blob[:r.fixed_bytes - 8],
        "template_depth": blob[:5] + bytes([DEPTH + 1]) + blob[6:],
        "template_magic": blob_ng[:sec_ng + 4] + bytes([blob_ng[sec_ng + 4] ^ 0xFF])
        + blob_ng[sec_ng + 5:],
        "first_offset": _mutate(blob, off0, "<Q", first + 1),
        "body_truncated": _mutate(blob, off0 + 8, "<Q", first + 2),
        "channel_lengths": _mutate(blob, first + 4, "<I", 1 << 20),
    }
    for name, bad in cases.items():
        (tj, mj), (tt_, mt) = _messages(lambda: _read_all(jt)(bad), lambda: _read_all(tt)(bad))
        assert (tt_, mt) == (tj, mj), name
        assert tj in ("ValueError", "IndexError"), (name, tj, mj)


def test_corrupt_geometry_fails_in_both(content):
    _, _, blob, _ = _both_blobs(content, code_geometry=True)
    r = tt.TiledReader(blob)
    bad = bytearray(blob)
    bad[12 + 8 * len(r) + 8 * (len(r) + 1) + 20] ^= 0xFF
    with pytest.raises(Exception):
        jt.decode_tiled_frame(bytes(bad))
    with pytest.raises(Exception):
        _decode_cpu(bytes(bad))
