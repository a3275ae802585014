"""The port at depth 21 (the JAX package's uint64 code tier) against the
JAX package, on the same seeded numpy input.

On a tensor the port holds depth-21 codes in the flipped int64 form
(``ops/morton.py``); every comparison here crosses back to the JAX
package's uint64 values through ``codes_to_host``. Exact: codes, sort
orders, pad sentinels, structure (drop levels, subtree weights) and
topology. Coefficients: 1e-12 of the largest (float64; XLA:CPU fuses some
multiply-adds, the port does not), 1e-5 (float32). Streams: byte-identical
at float64 on non-integer attributes; cross-decodes within 1e-9 (float64)
/ 1e-3 (float32).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import unique_voxel_cloud
from raht3dgs_tpu.codec.bitstream import FrameStream as JaxStream
from raht3dgs_tpu.models import pipeline as jp
from raht3dgs_tpu.ops import morton as jm, raht as jr, raht_span as js
from raht3dgs_tpu_torch.codec.bitstream import FrameStream
from raht3dgs_tpu_torch.models import pipeline as tp
from raht3dgs_tpu_torch.ops import morton as tm, raht as tr, raht_span as ts
from raht3dgs_tpu_torch.ops import voxelize as tvox
from raht3dgs_tpu_torch.ops.raht import _code_lanes, _lanes_code

# the module (``raht3dgs_tpu.ops`` re-exports a function of the same name)
jvox = importlib.import_module("raht3dgs_tpu.ops.voxelize")
J = 21
TOP = 2**J - 1


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(seed, n):
    """Unique depth-21 voxels (JAX conftest cloud), the all-ones corner and
    the origin among them."""
    pts, codes, attrs = unique_voxel_cloud(np.random.default_rng(seed), n, J)
    pts[0] = 0
    pts[-1] = TOP
    return pts.astype(np.int64), attrs


def _frames(pts, attrs, bucket, jdt=jnp.float64):
    jf = jp.prepare_voxel_frame(pts, attrs, J, bucket=bucket, dtype=jdt)
    tf = tp.voxel_frame_from_arrays(np.array(jf.codes), np.array(jf.attributes),
                                    np.array(jf.weights), jf.n_voxels, J, jf.vmin,
                                    jf.width, device="cpu")
    return jf, tf


# -- codes -------------------------------------------------------------------


def test_morton_encode_decode_j21_all_ones_corner():
    V = np.random.default_rng(0).integers(0, 2**J, (4000, 3))
    V[:4] = [[TOP, TOP, TOP], [0, 0, 0], [TOP, 0, 0], [0, 0, TOP]]
    want = np.asarray(jm.morton_encode(jnp.asarray(V), J))
    got = tm.morton_encode(torch.as_tensor(V), J)
    assert got.dtype == torch.int64 and (got < 0).all()      # the flipped form
    np.testing.assert_array_equal(tm.codes_to_host(got, J), want.astype(np.uint64))
    assert int(tm.codes_to_host(got[:1], J)[0]) == 2**63 - 1
    np.testing.assert_array_equal(tm.morton_decode(got, J).numpy(), V)
    # the JAX package's plain int64 values decode alike (bit 63 is no coordinate)
    np.testing.assert_array_equal(tm.morton_decode(torch.as_tensor(want.copy()), J).numpy(), V)


def test_code_lanes_round_trip_j21():
    V = np.random.default_rng(1).integers(0, 2**J, (3000, 3))
    V[0] = TOP
    codes = torch.cat([tm.morton_encode(torch.as_tensor(V), J),
                       tm.pad_code(J, 1 << 13, torch.arange(5, 10))])
    for fdt in (torch.float32, torch.float64):
        lanes = _code_lanes(codes, fdt)
        assert (lanes >= 0).all() and (lanes < 2**22).all()   # exact in float32
        assert torch.equal(_lanes_code(lanes, torch.int64), codes)


@pytest.mark.parametrize("n", [1, 1000, 1 << 19])
def test_pad_code_dtype_and_order_j21(n):
    assert tm.code_dtype(J, n) == torch.int64 and tm.flipped_tier(J)
    assert np.dtype(jm.code_dtype(J, n)) == np.uint64
    assert tm.internal_payload_bits(J, n) == jm.internal_payload_bits(J, n) == 63
    slots = np.arange(max(0, n - 5), n)
    want = np.asarray(jm.pad_code(J, n, jnp.asarray(slots)))
    got = tm.pad_code(J, n, torch.as_tensor(slots))
    np.testing.assert_array_equal(tm.codes_to_host(got, J), want)
    # signed order of the flipped form is unsigned order of the JAX values
    rng = np.random.default_rng(n)
    u = np.concatenate([rng.integers(0, 2**63 - 1, 500, dtype=np.int64).astype(np.uint64),
                        want])
    t = tm.codes_from_host(u, J, device="cpu")
    np.testing.assert_array_equal(tm.codes_to_host(torch.sort(t).values, J), np.sort(u))
    q = np.sort(u)
    idx = torch.searchsorted(torch.sort(t).values, t)
    np.testing.assert_array_equal(idx.numpy(), np.searchsorted(q, u))
    # the XOR of two codes survives the flip
    np.testing.assert_array_equal(tm.codes_to_host(t[1:] ^ t[:-1], 1).view(np.uint64),
                                  u[1:] ^ u[:-1])


def test_host_boundary_helpers():
    u = np.array([0, 5, 2**63 - 1, 2**63, 2**63 + 7], dtype=np.uint64)
    t = tm.codes_from_host(u, J, device="cpu")
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(tm.codes_to_host(t, J), u)
    np.testing.assert_array_equal(tm.codes_to_host(t.numpy(), J), u)
    # plain int64 JAX values (depth 21 real codes) take the same form
    assert torch.equal(tm.codes_from_host(u[:3].astype(np.int64), J, device="cpu"), t[:3])
    # below depth 21 both helpers pass the codes through
    c = np.array([3, 9, 70], np.int64)
    assert tm.codes_to_host(torch.as_tensor(c), 20).dtype == np.int64
    assert torch.equal(tm.codes_from_host(c, 20, device="cpu"), torch.as_tensor(c))


def test_msb_reads_bit_63():
    x = np.array([-1, -(1 << 63), -(1 << 63) + 5, (1 << 62) + 1, 1, 3], np.int64)
    want = np.asarray(js._msb(jnp.asarray(x.view(np.uint64)), 64))
    np.testing.assert_array_equal(ts._msb(torch.as_tensor(x), 64).numpy(), want)
    np.testing.assert_array_equal(want, [63, 63, 63, 62, 0, 1])


# -- voxelizer -----------------------------------------------------------------


def test_voxelize_depth21_uint64_codes_exact():
    rng = np.random.default_rng(0)
    n = 500
    pts = rng.uniform(0, 2.0**J, (n, 3))
    pts[:3] = pts[3]                                    # a shared voxel
    PC = np.concatenate([pts, rng.uniform(0, 255, (n, 3))], axis=1)
    j = jvox.voxelize(jnp.asarray(PC), J)
    t = tvox.voxelize(torch.as_tensor(PC), J)
    nv = int(t.nvox)
    assert nv == int(j.nvox) == n - 3
    assert t.codes.dtype == torch.int64
    np.testing.assert_array_equal(tm.codes_to_host(t.codes, J), np.asarray(j.codes))
    for f in ("positions", "counts", "sort_idx", "point_voxel", "attributes"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    # the decode of the codes is the voxel coordinates
    np.testing.assert_array_equal(tm.morton_decode(t.codes[:nv], J).numpy(),
                                  t.positions[:nv].numpy())
    assert np.all(np.diff(tm.codes_to_host(t.codes, J)) > 0)


def test_voxelize_pc_header_depth21(tmp_path):
    rng = np.random.default_rng(2)
    PC = np.concatenate([rng.uniform(0, 1000, (300, 3)), rng.uniform(0, 255, (300, 3))], 1)
    outs = []
    for name, fn in (("j", jvox.voxelize_pc),
                     ("t", lambda P, p: tvox.voxelize_pc(P, p, device="cpu"))):
        outs.append(fn(PC, {"J": J, "writeFileOut": True, "filename": str(tmp_path / name)}))
    for a, b in zip(outs[0][:3], outs[1][:3]):
        np.testing.assert_array_equal(a, b)
    # DeltaPC's positions: XLA:CPU may fuse V0s - voxel_size * Vint
    np.testing.assert_allclose(outs[1][3], outs[0][3], rtol=0, atol=np.finfo(float).eps * 1000)
    hj = (tmp_path / "j_data.txt").read_text().splitlines()[0]
    ht = (tmp_path / "t_data.txt").read_text().splitlines()[0]
    assert ht == hj and ht.split()[4] == "21"
    assert (tmp_path / "t_vox.ply").read_bytes() == (tmp_path / "j_vox.ply").read_bytes()


# -- transforms ------------------------------------------------------------------


def test_span_depth21_uint64_matches_dense():
    pts, attrs = _cloud(3, 200)
    attrs = np.random.default_rng(3).normal(0, 50, attrs.shape)
    jf, tf = _frames(pts, attrs, 256)
    drop, prev_ge, next_ge, levels, _ = js._span_topology(jf.codes, J)
    tdrop, tprev, tnext, tlevels, _ = ts._span_topology(tf.codes, J)
    assert tlevels == levels == 64
    for a, b in ((tdrop, drop), (tprev, prev_ge), (tnext, next_ge)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = js.raht_forward_span(jf.codes, jf.attributes, jf.weights, J)
    span = ts.raht_forward_span(tf.codes, tf.attributes, tf.weights, J)
    dense = tr.raht_forward(tf.codes, tf.attributes, tf.weights, J)
    jdense = jr.raht_forward(jf.codes, jf.attributes, jf.weights, J)
    n = jf.n_voxels
    c = np.asarray(jdense.coeffs)
    scale = np.abs(c).max()
    assert np.abs(dense.coeffs.numpy() - c).max() <= 1e-12 * scale
    assert np.abs(span.coeffs.numpy()[:n] - dense.coeffs.numpy()[:n]).max() <= 1e-9
    assert np.abs(span.coeffs.numpy() - np.asarray(want.coeffs)).max() <= 1e-12 * scale
    for got in (span.structure, dense.structure):
        np.testing.assert_array_equal(got.drop_level.numpy(),
                                      np.asarray(jdense.structure.drop_level))
    np.testing.assert_array_equal(dense.structure.subtree_w.numpy(),
                                  np.asarray(jdense.structure.subtree_w))
    st = tr.raht_structure(tf.codes, tf.weights, J)
    assert torch.equal(st.drop_level, dense.structure.drop_level)
    rec = ts.raht_inverse_span(span.coeffs, tf.codes, tf.weights, J).numpy()[:n]
    rec_d = tr.raht_inverse(dense.coeffs, dense.structure, J).numpy()[:n]
    assert np.abs(rec - attrs).max() <= 1e-9 and np.abs(rec_d - attrs).max() <= 1e-9


def test_span_depth21_f32_matches_jax():
    pts, attrs = _cloud(4, 300)
    jf, tf = _frames(pts, attrs, 512, jnp.float32)
    want = np.asarray(js.raht_forward_span(jf.codes, jf.attributes, jf.weights, J).coeffs,
                      np.float64)
    got = ts.raht_forward_span(tf.codes, tf.attributes, tf.weights, J)
    assert np.abs(got.coeffs.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    rec = ts.raht_inverse_span(got.coeffs, tf.codes, tf.weights, J).numpy()[:jf.n_voxels]
    assert np.abs(rec - attrs).max() < 1e-3


# -- codec -------------------------------------------------------------------------


def _symbols(stream, n):
    from raht3dgs_tpu_torch.codec.rlgr import rlgr_decode_channels

    out = np.zeros((stream.n_channels, n), np.int32)
    rlgr_decode_channels(stream.channels, n, out=out, chunk=stream.chunk)
    return out


@pytest.mark.parametrize("jdt", [jnp.float64, jnp.float32])
def test_codec_at_maximum_depth_21(jdt):
    pts, attrs = _cloud(5, 300)
    jf, tf = _frames(pts, attrs, 512, jdt)
    tdt = torch.float64 if jdt == jnp.float64 else torch.float32
    jc = jp.AttributeCodec(J, dtype=jdt)
    tc = tp.AttributeCodec(J, dtype=tdt, device="cpu")
    # the port's own frame: the same codes as the JAX frame's
    own = tp.prepare_voxel_frame(pts, attrs, J, bucket=512, dtype=tdt, device="cpu")
    assert torch.equal(own.codes, tf.codes)
    assert own.codes.dtype == torch.int64
    jb = jc.encode(jf, 2.0).stream.to_bytes()
    tb = tc.encode(tf, 2.0).stream.to_bytes()
    n = jf.n_voxels
    if jdt == jnp.float64:
        assert tb == jb      # non-integer attributes: no quantization ties
    else:
        a, b = _symbols(FrameStream.from_bytes(tb), n), _symbols(JaxStream.from_bytes(jb), n)
        assert (a != b).mean() < 1e-3 and np.abs(a - b).max() <= 1
    tol = 1e-9 if jdt == jnp.float64 else 1e-3
    for blob in (jb, tb):
        rec_t, _ = tc.decode(FrameStream.from_bytes(blob), tf.codes, tf.weights)
        rec_j, _ = jc.decode(JaxStream.from_bytes(blob), jf.codes, jf.weights)
        assert np.abs(rec_t - np.asarray(rec_j)).max() < tol
        assert np.abs(rec_t - attrs).max() < 2.0 * 1.1
    # the sweep gives the per-step bytes
    sweep = tc.encode_sweep(tf, [2.0, 8.0])
    assert sweep[0].stream.to_bytes() == tb
    assert sweep[1].stream.to_bytes() == tc.encode(tf, 8.0).stream.to_bytes()


def test_decode_lod_and_progressive_j21_match_jax():
    pts, attrs = _cloud(6, 400)
    jf, tf = _frames(pts, attrs, 512)
    tc = tp.AttributeCodec(J, device="cpu")
    jc = jp.AttributeCodec(J)
    blob = tc.encode(tf, 1.0).stream.to_bytes()
    codes = tm.codes_to_host(tf.codes[:tf.n_voxels], J)
    for lod in (1, 4, 19, 21):
        assert tp.lod_prefix_count(codes, J, lod) == jp.lod_prefix_count(
            np.asarray(jf.codes)[:jf.n_voxels], J, lod)
        pos_t, rec_t, w_t = tc.decode_lod(FrameStream.from_bytes(blob), tf.codes,
                                          tf.weights, lod)
        pos_j, rec_j, w_j = jc.decode_lod(JaxStream.from_bytes(blob), jf.codes,
                                          jf.weights, lod)
        np.testing.assert_array_equal(pos_t, np.asarray(pos_j))
        np.testing.assert_array_equal(w_t, w_j)
        assert np.abs(rec_t - rec_j).max() < 1e-9
    rec_t, _ = tc.decode_progressive(FrameStream.from_bytes(blob), tf.codes, tf.weights, 37)
    rec_j, _ = jc.decode_progressive(JaxStream.from_bytes(blob), jf.codes, jf.weights, 37)
    assert np.abs(rec_t - np.asarray(rec_j)).max() < 1e-9


def test_predict_host_j21_matches_jax():
    pts, attrs = _cloud(7, 300)
    jf, tf = _frames(pts, attrs, 512)
    tc = tp.AttributeCodec(J, predict=True, device="cpu")
    assert not tc._predict_on_device()
    tc.device = torch.device("cuda")       # as a CUDA codec would see it
    assert not tc._predict_on_device()     # auto keeps the host loop above depth 20
    tc.device = torch.device("cpu")
    jb = jp.AttributeCodec(J, predict=True, predict_impl="host").encode(jf, 2.0) \
        .stream.to_bytes()
    tb = tc.encode(tf, 2.0).stream.to_bytes()
    assert tb == jb
    rec, _ = tc.decode(FrameStream.from_bytes(tb), tf.codes, tf.weights)
    assert np.abs(rec - attrs).max() < 2.0 * 1.1
    for mk in (lambda: jp.AttributeCodec(J, predict=True, predict_impl="device"),
               lambda: tp.AttributeCodec(J, predict=True, predict_impl="device",
                                         device="cpu")):
        with pytest.raises(ValueError, match=r"\(depth <= 20\), got depth=21; use 'host'"):
            mk()


@pytest.mark.parametrize("impl", ["compact", "scan"])
def test_level_loop_refusals_match_jax(impl):
    pts, attrs = _cloud(8, 50)
    jf, tf = _frames(pts, attrs, 64)
    fn = {"compact": "raht_compact.raht_forward_compact",
          "scan": "raht_scan.raht_forward_scan"}[impl]
    mod, name = fn.split(".")
    jfn = getattr(importlib.import_module(f"raht3dgs_tpu.ops.{mod}"), name)
    tfn = getattr(importlib.import_module(f"raht3dgs_tpu_torch.ops.{mod}"), name)
    with pytest.raises(NotImplementedError) as je:
        jfn(jf.codes, jf.attributes, jf.weights, J)
    with pytest.raises(NotImplementedError) as te:
        tfn(tf.codes, tf.attributes, tf.weights, J)
    assert str(te.value) == str(je.value)
    with pytest.raises(NotImplementedError, match="uint64 depth-21"):
        tp.AttributeCodec(J, impl=impl, device="cpu").encode(tf, 1.0)
    # dense runs the tier and gives span's stream
    d = tp.AttributeCodec(J, impl="dense", device="cpu").encode(tf, 1.0).stream.to_bytes()
    assert d == tp.AttributeCodec(J, device="cpu").encode(tf, 1.0).stream.to_bytes()


# -- the other host boundaries -----------------------------------------------------


def test_geometry_sections_j21_match_jax():
    from raht3dgs_tpu.codec import geometry as jg
    from raht3dgs_tpu_torch.codec import geometry as tg

    pts, attrs = _cloud(9, 300)
    tf = tp.prepare_voxel_frame(pts, attrs, J, bucket=512, device="cpu")
    host = tm.codes_to_host(tf.codes[:tf.n_voxels], J)
    assert host.dtype == np.uint64
    want = jg.encode_geometry(np.asarray(jm.morton_encode(jnp.asarray(pts), J))[
        np.argsort(np.asarray(jm.morton_encode(jnp.asarray(pts), J)))], J)
    assert tg.encode_geometry(host, J) == want
    assert tg.geometry_from_positions(pts, J) == want
    np.testing.assert_array_equal(tg.decode_geometry(want, J, len(pts)).astype(np.uint64),
                                  host)
    mv = np.array([3, -2, 1])
    np.testing.assert_array_equal(tg._shift_codes(host, J, mv), jg._shift_codes(host, J, mv))


def test_tiled_frame_j21_matches_jax():
    from raht3dgs_tpu.models import tiling as jt
    from raht3dgs_tpu_torch.models import tiling as tt

    pts, _ = _cloud(10, 300)
    attrs = np.random.default_rng(10).uniform(0, 255, (len(pts), 3))
    jb, jstats = jt.encode_tiled_frame(pts, attrs, J, 1, jp.AttributeCodec(J), 2.0,
                                       code_geometry=True)
    tb, tstats = tt.encode_tiled_frame(pts, attrs, J, 1, tp.AttributeCodec(J, device="cpu"),
                                       2.0, code_geometry=True)
    assert tb == jb and tstats == jstats
    codes = np.asarray(jm.morton_encode(jnp.asarray(pts), J))
    np.testing.assert_array_equal(tt.brick_keys_np(codes, J, 2), jt.brick_keys_np(codes, J, 2))
    V, A = tt.decode_tiled_frame(tb, device="cpu")
    Vj, Aj = jt.decode_tiled_frame(jb)
    np.testing.assert_array_equal(V, np.asarray(Vj))
    assert np.abs(A - np.asarray(Aj)).max() < 1e-9


def test_motion_sections_and_block_rows_j21_match_jax():
    from raht3dgs_tpu.models import temporal as jtm
    from raht3dgs_tpu.ops import temporal as jto
    from raht3dgs_tpu_torch.models import temporal as ttm
    from raht3dgs_tpu_torch.ops import temporal as tto

    pts, attrs = _cloud(11, 400)
    jf, tf = _frames(pts, attrs, 512)
    jcodes = np.asarray(jf.codes)
    n, P = jf.n_voxels, jcodes.shape[0]
    for bsl in (4, 19):
        want = jto.block_first(jcodes[:n], J, bsl)
        np.testing.assert_array_equal(tto.block_first(tm.codes_to_host(tf.codes[:n], J),
                                                      J, bsl), want)
        np.testing.assert_array_equal(tto.block_first(tf.codes[:n], J, bsl).numpy(), want)
    mv = np.random.default_rng(11).integers(-3, 4, (P, 3)).astype(np.int32)
    g = np.array([1, 0, -1])
    host = tm.codes_to_host(tf.codes, J)
    want = jtm._pack_motion(jcodes, n, J, 4, g, mv)
    assert ttm._pack_motion(host, n, J, 4, g, mv) == want
    np.testing.assert_array_equal(ttm._unpack_motion(want, host, n, P, J),
                                  jtm._unpack_motion(want, jcodes, n, P, J))
    # the probe joins on the flipped codes: the JAX package's matches
    pred_j, found_j = jto.predict_from_previous(jf.codes, jf.codes, jf.attributes,
                                                jf.weights, J, probes=7, motion=g)
    for join in ("search", "sort"):
        pred_t, found_t = tto.predict_from_previous(tf.codes, tf.codes, tf.attributes,
                                                    tf.weights, J, probes=7, motion=g,
                                                    join=join)
        np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
        np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))


def test_eval_synth_voxels_j21_match_jax():
    from raht3dgs_tpu.eval import synth as jsy
    from raht3dgs_tpu_torch.eval import synth as tsy

    a = tsy._unique_morton_voxels(np.random.default_rng(12), 200, J)
    b = jsy._unique_morton_voxels(np.random.default_rng(12), 200, J)
    np.testing.assert_array_equal(a, np.asarray(b))


# -- the CLIs ----------------------------------------------------------------------


@pytest.fixture
def no_jax_cache(monkeypatch):
    # the JAX CLIs turn on a persistent compile cache unless this is empty
    monkeypatch.setenv("RAHT3DGS_COMPILE_CACHE", "")


def _csv_rows(path):
    lines = path.read_text().strip().splitlines()
    return lines[0], [ln.split(",") for ln in lines[1:]]


@pytest.mark.parametrize("extra", [[], ["--code-geometry"], ["--predict"],
                                   ["--tiles", "3", "--code-geometry"]],
                         ids=["plain", "geometry", "predict", "tiles"])
def test_cli_encode_ply_depth21_matches_jax(tmp_path, no_jax_cache, extra):
    """encode_ply --depth 21 --voxelize with both packages on one raw PLY:
    the same CSV rows and stream bytes; decode of the JAX stream with and
    without --positions gives the JAX decode CLI's PLY."""
    from raht3dgs_tpu.cli import decode as jdec, encode_ply as jenc
    from raht3dgs_tpu_torch.cli import decode as tdec, encode_ply as tenc
    from raht3dgs_tpu_torch.io.ply import read_ply_8i, save_ply_ascii
    from raht3dgs_tpu_torch.utils import synth

    pts, rgb = synth.raw_surface_cloud(600, seed=3)
    ply = tmp_path / "raw.ply"
    save_ply_ascii(ply, pts.astype(np.float64), rgb.astype(int))
    steps = ["2"] if "--tiles" in extra else ["2", "8"]
    common = ["--input", str(ply), "--voxelize", "--depth", "21", "--steps", *steps,
              "--platform", "cpu", "--bucket", "1024"] + extra
    for name, cli in (("j", jenc), ("t", tenc)):
        assert cli.main(common + ["--csv", str(tmp_path / f"{name}.csv"),
                                  "--save-streams", str(tmp_path / name)]) == 0
    (jh, jrows), (th, trows) = _csv_rows(tmp_path / "j.csv"), _csv_rows(tmp_path / "t.csv")
    assert th == jh and len(trows) == len(jrows) == len(steps)
    for a, b in zip(trows, jrows):
        assert a[:3] == b[:3] and abs(float(a[-1]) - float(b[-1])) <= 1e-6
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for nm in names:
        assert (tmp_path / "t" / nm).read_bytes() == (tmp_path / "j" / nm).read_bytes(), nm
    if "--tiles" in extra:
        return
    stream = str(tmp_path / "j" / names[0])
    V, C, _ = read_ply_8i(ply)
    res = tvox.voxelize(np.concatenate([V, C], axis=1), J, device="cpu")
    pos = tmp_path / "pos.ply"
    save_ply_ascii(pos, res.positions[:int(res.nvox)].numpy().astype(float), width=TOP)
    runs = [["--positions", str(pos)]] + ([[]] if "--code-geometry" in extra else [])
    for k, dec_extra in enumerate(runs):
        for name, cli in (("j", jdec), ("t", tdec)):
            assert cli.main(["--stream", stream, "--output",
                             str(tmp_path / f"rec{k}_{name}.ply"), "--platform", "cpu",
                             "--bucket", "1024"] + dec_extra) == 0
        assert (tmp_path / f"rec{k}_t.ply").read_bytes() == \
            (tmp_path / f"rec{k}_j.ply").read_bytes()
    if len(runs) == 2:   # positions exact from the geometry section alone
        a, _, _ = read_ply_8i(tmp_path / "rec1_t.ply")
        got = torch.sort(tm.morton_encode(torch.as_tensor(a.astype(np.int64)), J)).values
        want = torch.sort(res.codes[:int(res.nvox)]).values
        assert torch.equal(got, want)


def test_batched_span_forms_j21_equal_single_frames():
    """The batched span forms (the batch codec's) at 64 levels: frame b of
    the stack is the single-frame function's result on frame b, bit for
    bit, in float32 (the batched scan entry's plain version here) and
    float64."""
    for dt in (torch.float32, torch.float64):
        frames = []
        for seed in (13, 14):
            pts, attrs = _cloud(seed, 200)
            frames.append(tp.prepare_voxel_frame(pts, attrs, J, bucket=256, dtype=dt,
                                                 device="cpu"))
        codes = torch.stack([f.codes for f in frames])
        attrs = torch.stack([f.attributes for f in frames])
        w = torch.stack([f.weights for f in frames])
        fwd = ts.raht_forward_span_batched(codes, attrs, w, J)
        st = ts.raht_structure_span_batched(codes, w, J)
        rec = ts.raht_inverse_span_batched(fwd.coeffs, codes, w, J)
        for b, f in enumerate(frames):
            one = ts.raht_forward_span(f.codes, f.attributes, f.weights, J)
            assert torch.equal(fwd.coeffs[b], one.coeffs)
            assert torch.equal(fwd.structure.drop_level[b], one.structure.drop_level)
            assert torch.equal(st.node_weights[b],
                               ts.raht_structure_span(f.codes, f.weights, J).node_weights)
            assert torch.equal(rec[b], ts.raht_inverse_span(one.coeffs, f.codes, f.weights, J))
