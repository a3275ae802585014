"""The port's serving path (``models/serving.py``) and upload tiers against
the JAX package's, on the CPU.

The same streams and cameras go through both packages. Plain frames and
tiled plain bricks render within 5e-5 (the rasterizer's tolerance in
``test_torch_rasterize.py``); predicted frames and bricks within 1e-4 (two
non-normative float32 closed loops); I/P sequences within 2e-4 and
predicted sequences within 1e-3 (the JAX package's own pins,
``tests/test_serving.py``). uint8 images agree within one level. The host
packing of the upload tiers is numpy and must give the JAX package's arrays
exactly; the upload widens to the original matrix bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raht3dgs_tpu.codec.bitstream import write_sequence
from raht3dgs_tpu.codec.rlgr import rlgr_decode_channels
from raht3dgs_tpu.eval.cameras import generate_random_cameras, look_at_w2c
from raht3dgs_tpu.models import pipeline as jp, serving as js, tiling as jt
from raht3dgs_tpu.models.temporal import SequenceCodec
from raht3dgs_tpu.ops.prelude import morton_codes_np
from raht3dgs_tpu_torch.codec import bitstream as tbs
from raht3dgs_tpu_torch.eval.rasterize import _rasterize_tiled
from raht3dgs_tpu_torch.models import pipeline as tp, serving as ts, tiling as tt
from raht3dgs_tpu_torch.ops.morton import morton_decode

DEPTH = 5
SIZE = 64
STEP = 0.002
RASTER = dict(sh_degree=3, tile=16, max_tiles_per_gauss=16, max_per_tile=1024, chunk=64)
PLAIN_TOL = 5e-5
PREDICT_TOL = 1e-4
SEQ_TOL = 2e-4
SEQ_PREDICT_TOL = 1e-3
VMIN = np.array([-1.0, -1.0, -1.0])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gs_attrs(rng, n):
    attrs = np.concatenate([rng.normal(size=(n, 4)), rng.uniform(0.02, 0.06, (n, 3)),
                            rng.uniform(0.3, 1.0, (n, 1)), rng.normal(0, 0.3, (n, 48))],
                           axis=1)
    attrs[:, 0:4] /= np.linalg.norm(attrs[:, 0:4], axis=1, keepdims=True)
    return attrs


def _positions(codes):
    return morton_decode(torch.as_tensor(codes.astype(np.int64)), DEPTH).numpy()


def _cameras(v, seed=3, center=np.zeros(3), radius=2.5):
    vms, Ks, _, _ = generate_random_cameras(center, radius, n_views=v, image_width=SIZE,
                                            image_height=SIZE, seed=seed)
    return np.asarray(vms, np.float32), np.asarray(Ks, np.float32)


def _max_diff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _not_blank(imgs):
    assert float(np.asarray(imgs, np.float64).std()) > 1e-4, "blank renders"


@pytest.fixture(scope="module")
def served():
    """A 56-channel float32 frame at J=5 coded plain and predicted, with
    each package's frame state, symbols and inverse order."""
    rng = np.random.default_rng(0)
    pts = rng.integers(0, 2**DEPTH, (1600, 3))
    pos = _positions(np.unique(morton_codes_np(pts, DEPTH))[:400])
    attrs = _gs_attrs(rng, len(pos)).astype(np.float32)
    jf = jp.prepare_voxel_frame(pos, attrs, DEPTH, bucket=len(pos), dtype=jnp.float32)
    tf = tp.voxel_frame_from_arrays(np.array(jf.codes), np.array(jf.attributes),
                                    np.array(jf.weights), jf.n_voxels, DEPTH, jf.vmin,
                                    jf.width, device="cpu")
    out = {"jf": jf, "tf": tf, "vs": np.float32(2.0 / 2**DEPTH), "vmin": VMIN}
    for name, kw in (("plain", {}), ("predict", dict(predict=True, predict_impl="host"))):
        codec = jp.AttributeCodec(DEPTH, dtype=jnp.float32, **kw)
        stream = codec.encode(jf, STEP).stream
        vals_T = np.zeros((stream.n_channels, jf.codes.shape[0]), dtype=np.int32)
        rlgr_decode_channels(stream.channels, stream.n_voxels, out=vals_T, chunk=stream.chunk)
        t_stream = tbs.FrameStream.from_bytes(stream.to_bytes())
        t_vals = np.zeros_like(vals_T)
        tp.decode_entropy_channels(t_stream, t_stream.n_voxels, t_vals)
        np.testing.assert_array_equal(t_vals, vals_T)
        out[name] = dict(codec=codec, stream=stream, t_stream=t_stream, vals_T=vals_T,
                         j_inv=js.build_inverse_order(jf.codes, jf.weights,
                                                      jnp.int32(stream.n_voxels), DEPTH,
                                                      stream.order_mode),
                         t_inv=ts.build_inverse_order(tf.codes, tf.weights, stream.n_voxels,
                                                      DEPTH, stream.order_mode))
    np.testing.assert_array_equal(out["plain"]["t_inv"].numpy(), np.asarray(out["plain"]["j_inv"]))
    return out


def _serve_plain_both(served, vals_T, image_dtype=None, views=2):
    jf, tf, p = served["jf"], served["tf"], served["plain"]
    vms, Kms = _cameras(views)
    kw = dict(depth=DEPTH, width=SIZE, height=SIZE, **RASTER)
    j = js.serve_frame(jnp.asarray(vals_T), p["j_inv"], jnp.float32(STEP), jf.codes,
                       jf.weights, jnp.float32(served["vs"]), jnp.asarray(VMIN, jnp.float32),
                       jnp.asarray(vms), jnp.asarray(Kms), jnp.ones(3, jnp.float32),
                       image_dtype=jnp.uint8 if image_dtype == "u8" else jnp.float32, **kw)
    t = ts.serve_frame(vals_T, p["t_inv"], STEP, tf.codes, tf.weights, served["vs"], VMIN,
                       vms, Kms, np.ones(3),
                       image_dtype=torch.uint8 if image_dtype == "u8" else torch.float32, **kw)
    return j, t


@pytest.mark.parametrize("image_dtype", ["f32", "u8"])
def test_serve_frame_matches_jax(served, image_dtype):
    """Plain frame: the port's images within 5e-5 of JAX ``serve_frame``
    (uint8: within one level), the clip counters equal."""
    (ji, jd, jtl), (ti, td, ttl) = _serve_plain_both(served, served["plain"]["vals_T"],
                                                     image_dtype)
    assert ti.shape == (2, SIZE, SIZE, 3)
    if image_dtype == "u8":
        assert ti.dtype == torch.uint8
        assert _max_diff(ti.numpy(), np.asarray(ji)) <= 1
    else:
        assert _max_diff(ti.numpy(), np.asarray(ji)) <= PLAIN_TOL
        _not_blank(ti.numpy())
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ttl.numpy(), np.asarray(jtl))


def test_serve_frame_equals_its_split_render(served):
    """serve_frame is decode_scene_device followed by one render per view."""
    tf, p = served["tf"], served["plain"]
    vms, Kms = _cameras(2)
    imgs, _, _ = ts.serve_frame(p["vals_T"], p["t_inv"], STEP, tf.codes, tf.weights,
                                served["vs"], VMIN, vms, Kms, depth=DEPTH, width=SIZE,
                                height=SIZE, **RASTER)
    scene = ts.decode_scene_device(p["vals_T"], p["t_inv"], STEP, tf.codes, tf.weights,
                                   served["vs"], VMIN, depth=DEPTH)
    for v in range(2):
        img, _ = _rasterize_tiled(*scene, torch.as_tensor(vms[v]), torch.as_tensor(Kms[v]),
                                  torch.ones(3), width=SIZE, height=SIZE, **RASTER)
        np.testing.assert_array_equal(imgs[v].numpy(), img.numpy())


def test_serve_frame_predicted_matches_jax_and_host(served):
    """Predicted frame: the device closed loop within 1e-4 (atol and rtol)
    of the port's host decode, the images within 1e-4 of JAX
    ``serve_frame_predicted`` and of the render of the host decode."""
    from raht3dgs_tpu.models.pipeline import _scale_sqrt_w, _transform_device
    from raht3dgs_tpu.ops.praht_device import praht_device_plan

    jf, tf, p = served["jf"], served["tf"], served["predict"]
    st = p["t_stream"]
    assert st.predict
    vms, Kms = _cameras(2)
    kw = dict(depth=DEPTH, width=SIZE, height=SIZE, quant_mode=st.quant_mode,
              rec_delta=st.rec_delta, **RASTER)
    _, _, structure = _transform_device(jf.codes, _scale_sqrt_w(jf.attributes, jf.weights),
                                        jf.weights, DEPTH, "ragft", p["codec"].impl)
    j_plan = praht_device_plan(jf.codes, jf.weights, DEPTH, structure.drop_level,
                               structure.subtree_w)
    steps = jnp.atleast_1d(jnp.asarray(STEP, jnp.float32))
    ji, jd, jtl = js.serve_frame_predicted(
        jnp.asarray(p["vals_T"]), p["j_inv"], j_plan, jnp.uint32(st.predict_mask), steps,
        jf.codes, jf.weights, jnp.float32(served["vs"]), jnp.asarray(VMIN, jnp.float32),
        jnp.asarray(vms), jnp.asarray(Kms), jnp.ones(3, jnp.float32), **kw)
    t_plan = ts._plan_of(tf.codes, tf.weights, DEPTH)
    ti, td, ttl = ts.serve_frame_predicted(p["vals_T"], p["t_inv"], t_plan, st.predict_mask,
                                           np.array([STEP]), tf.codes, tf.weights,
                                           served["vs"], VMIN, vms, Kms, np.ones(3), **kw)
    _not_blank(ti.numpy())
    assert _max_diff(ti.numpy(), np.asarray(ji)) <= PREDICT_TOL
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ttl.numpy(), np.asarray(jtl))

    codec = tp.AttributeCodec(DEPTH, dtype=torch.float32, predict=True, device="cpu")
    rec_host, _ = codec.decode(st, tf.codes, tf.weights)
    scene = ts.decode_scene_device_predicted(p["vals_T"], p["t_inv"], t_plan,
                                             st.predict_mask, np.array([STEP]), tf.codes,
                                             tf.weights, served["vs"], VMIN, depth=DEPTH,
                                             quant_mode=st.quant_mode,
                                             rec_delta=st.rec_delta)
    sym = torch.as_tensor(p["vals_T"]).T[p["t_inv"].long()]
    from raht3dgs_tpu_torch.ops.praht_device import praht_device_decode

    rec_dev = praht_device_decode(t_plan, tf.codes, tf.weights, sym, st.predict_mask, DEPTH,
                                  torch.tensor([STEP]), quant_mode=st.quant_mode,
                                  rec_delta=st.rec_delta, fdtype=torch.float32)
    np.testing.assert_allclose(rec_dev.numpy()[:tf.n_voxels], rec_host, atol=1e-4, rtol=1e-4)
    full = torch.zeros(tf.codes.shape[0], rec_host.shape[1])
    full[:tf.n_voxels] = torch.as_tensor(rec_host)
    host_scene = ts._scene_from_attrs(full, tf.codes, tf.weights, served["vs"], VMIN, DEPTH)
    ref, _, _ = ts._render_scene_views(host_scene, vms, Kms, None, width=SIZE, height=SIZE,
                                       **RASTER)
    assert _max_diff(ti.numpy(), ref.numpy()) <= PREDICT_TOL
    assert len(scene) == 5


UPLOAD_CASES = {
    "int8": lambda rng: np.arange(-50, 50, dtype=np.int32).reshape(4, 25),
    "int8_patch": lambda rng: _with(rng.integers(-100, 100, (7, 300)), [5, 900, 2001],
                                    [40_000, -130, 128]),
    "int16": lambda rng: np.full((8, 64), 1000, dtype=np.int32),
    "int16_patch": lambda rng: _with(rng.integers(-2000, 2000, (7, 300)),
                                     rng.choice(2100, 5, replace=False),
                                     [40_000, -40_000, 1 << 20, -(1 << 20), 32_768]),
    "int16_patch_batched": lambda rng: _with(rng.integers(-2000, 2000, (2, 7, 300)),
                                             rng.choice(4200, 5, replace=False),
                                             [40_000, -40_000, 1 << 20, -(1 << 20), 32_768]),
    "int32": lambda rng: np.full((8, 32), 40_000, dtype=np.int32),
    "sparse_int8": lambda rng: _sparse(rng, 100),
    "sparse_int16": lambda rng: _sparse(rng, 20_000),
    "sparse_int32": lambda rng: _sparse(rng, 1 << 20),
    "sparse_one_outlier": lambda rng: _with(np.zeros((8, 64)), [0], [40_000]),
    "zeros": lambda rng: np.zeros((8, 256), dtype=np.int32),
    "int16_values": lambda rng: rng.integers(-30000, 30000, (3, 50)).astype(np.int16),
}


def _with(vals, idx, new):
    vals = np.asarray(vals).astype(np.int32)
    vals.reshape(-1)[np.asarray(idx)] = new
    return vals


def _sparse(rng, hi):
    vals = np.zeros((56, 2048), dtype=np.int32)
    flat = vals.reshape(-1)
    pos = rng.choice(flat.size, size=flat.size // 100, replace=False)
    flat[pos] = rng.integers(1, hi, size=pos.size)
    flat[pos[0]] = hi - 1
    return vals


SWITCHES = {"default": {}, "no_patch": {"RAHT3DGS_UPLOAD_PATCH": "0"},
            "no_sparse": {"RAHT3DGS_UPLOAD_SPARSE": "0"},
            "neither": {"RAHT3DGS_UPLOAD_PATCH": "0", "RAHT3DGS_UPLOAD_SPARSE": "0"}}


@pytest.mark.parametrize("switches", list(SWITCHES))
@pytest.mark.parametrize("case", list(UPLOAD_CASES))
def test_upload_tiers_match_jax(monkeypatch, case, switches):
    """pack_quantized_upload: the JAX package's tier, dtype, patch and
    padding, array for array; upload_quantized widens to the matrix bitwise
    (the JAX device upload too)."""
    for k, v in SWITCHES[switches].items():
        monkeypatch.setenv(k, v)
    vals = UPLOAD_CASES[case](np.random.default_rng(7))
    up_j = jp.pack_quantized_upload(vals)
    up_t = tp.pack_quantized_upload(vals)
    assert up_t.shape == up_j.shape
    for a, b in zip(up_t[:3], up_j[:3]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tp.quantized_upload_array(vals).dtype == jp.quantized_upload_array(vals).dtype
    got = ts.upload_quantized(up_t, device="cpu")
    want = np.asarray(jp.upload_quantized(up_j))
    assert got.dtype == {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
                         np.dtype(np.int32): torch.int32}[want.dtype]
    np.testing.assert_array_equal(got.to(torch.int32).numpy(), vals.astype(np.int32))
    np.testing.assert_array_equal(want.astype(np.int32), vals.astype(np.int32))


def test_upload_tiers_pick_as_named():
    """The tiers the cases above are named for (a guard on the fixtures)."""
    rng = np.random.default_rng(7)
    picks = {}
    for case, make in UPLOAD_CASES.items():
        up = tp.pack_quantized_upload(make(rng))
        picks[case] = ("sparse" if up.shape is not None else "dense",
                       up.vals.dtype.name, int(up.patch_idx.size))
    assert picks["int8"] == ("dense", "int8", 0)
    assert picks["int8_patch"] == ("dense", "int8", 8)
    assert picks["int16"] == ("dense", "int16", 0)
    assert picks["int16_patch"] == ("dense", "int16", 8)
    assert picks["int32"] == ("dense", "int32", 0)
    assert [picks[f"sparse_int{b}"][:2] for b in (8, 16, 32)] == \
        [("sparse", "int8"), ("sparse", "int16"), ("sparse", "int32")]
    assert picks["sparse_one_outlier"] == ("sparse", "int32", 64)


@pytest.mark.parametrize("tier", ["int16_patch", "sparse"])
def test_upload_tiers_serve_bitwise(served, tier):
    """A frame served from the patched or the sparse upload renders bitwise
    as from the int32 matrix."""
    tf, p = served["tf"], served["plain"]
    vals = p["vals_T"].copy()
    if tier == "sparse":
        vals[:, 16:] = 0
    else:
        vals[3, 7] = 50_000
    up = tp.pack_quantized_upload(vals)
    assert (up.shape is not None) == (tier == "sparse")
    vms, Kms = _cameras(2)
    kw = dict(depth=DEPTH, width=SIZE, height=SIZE, **RASTER)
    a = ts.serve_frame(ts.upload_quantized(up, device="cpu"), p["t_inv"], STEP, tf.codes,
                       tf.weights, served["vs"], VMIN, vms, Kms, **kw)
    b = ts.serve_frame(vals, p["t_inv"], STEP, tf.codes, tf.weights, served["vs"], VMIN,
                       vms, Kms, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.fixture(scope="module")
def tiled():
    """Two opposite octants of the J=5 grid (two bricks at brick depth 1),
    56 float32 channels, coded plain and predicted, with the global world
    mapping (vmin -1, width 2)."""
    rng = np.random.default_rng(1)
    side, h = 2**DEPTH, 2**(DEPTH - 1)
    pts = np.concatenate([rng.integers(0, h, (480, 3)), rng.integers(h, side, (480, 3))])
    V = _positions(np.unique(morton_codes_np(pts, DEPTH)))
    attrs = _gs_attrs(rng, len(V))
    out = {"V": V}
    for name, kw in (("plain", {}), ("predict", dict(predict=True, predict_impl="host"))):
        codec = jp.AttributeCodec(DEPTH, dtype=jnp.float32, **kw)
        out[name], _ = jt.encode_tiled_frame(V, attrs, DEPTH, 1, codec, STEP,
                                             code_geometry=True, vmin=VMIN, width=2.0)
    return out


def _serve_tiled_both(blob, vms, Kms, **kw):
    ji, jd, jtl, jsel = js.serve_tiled_frame(
        blob, jnp.asarray(vms), jnp.asarray(Kms), jnp.ones(3, jnp.float32), width=SIZE,
        height=SIZE, bucket=64, **kw, **RASTER)
    ti, td, ttl, tsel = ts.serve_tiled_frame(blob, vms, Kms, np.ones(3), width=SIZE,
                                             height=SIZE, bucket=64, device="cpu", **kw,
                                             **RASTER)
    assert tsel == jsel
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ttl.numpy(), np.asarray(jtl))
    return np.asarray(ji), ti.numpy(), tsel


@pytest.mark.parametrize("kind", ["plain", "predict"])
def test_serve_tiled_frame_matches_jax(tiled, kind):
    """Every brick (a wide margin) and one brick (``bricks=``): the port's
    images within 5e-5 (plain) / 1e-4 (predicted) of JAX
    ``serve_tiled_frame``, the selections equal; the full serve also within
    that of the render of the port's normative tiled decode."""
    tol = PLAIN_TOL if kind == "plain" else PREDICT_TOL
    blob = tiled[kind]
    vms, Kms = _cameras(2)
    ji, ti, sel = _serve_tiled_both(blob, vms, Kms, margin=4.0)
    assert sel == [0, 1]
    _not_blank(ti)
    assert _max_diff(ti, ji) <= tol
    Vd, Ad = tt.decode_tiled_frame(blob, dtype=torch.float32, device="cpu")
    codes = torch.as_tensor(morton_codes_np(Vd, DEPTH))
    scene = ts._scene_from_attrs(torch.as_tensor(Ad), codes, torch.ones(len(Vd)),
                                 2.0 / 2**DEPTH, VMIN, DEPTH)
    ref, _, _ = ts._render_scene_views(scene, vms, Kms, None, width=SIZE, height=SIZE,
                                       **RASTER)
    assert _max_diff(ti, ref.numpy()) <= tol
    ji, ti, sel = _serve_tiled_both(blob, vms, Kms, bricks=[1])
    assert sel == [1]
    assert _max_diff(ti, ji) <= tol


def test_serve_tiled_frame_u8_and_positions(tiled):
    """uint8 images within one level of the JAX package's; positions given
    instead of the geometry section serve the same images."""
    vms, Kms = _cameras(2)
    blob = tiled["plain"]
    ju, _, _, _ = js.serve_tiled_frame(blob, jnp.asarray(vms), jnp.asarray(Kms), width=SIZE,
                                       height=SIZE, bucket=64, margin=4.0,
                                       image_dtype=jnp.uint8, **RASTER)
    tu, _, _, _ = ts.serve_tiled_frame(blob, vms, Kms, width=SIZE, height=SIZE, bucket=64,
                                       margin=4.0, image_dtype=torch.uint8, device="cpu",
                                       **RASTER)
    assert tu.dtype == torch.uint8
    assert _max_diff(tu.numpy(), np.asarray(ju)) <= 1
    a, _, _, _ = ts.serve_tiled_frame(blob, vms, Kms, width=SIZE, height=SIZE, bucket=64,
                                      margin=4.0, device="cpu", **RASTER)
    b, _, _, _ = ts.serve_tiled_frame(blob, vms, Kms, width=SIZE, height=SIZE, bucket=64,
                                      margin=4.0, positions=tiled["V"], device="cpu",
                                      **RASTER)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_visible_bricks_match_jax(tiled):
    """The frustum cull: the JAX package's lists, for an orbit at several
    margins and for a camera with a brick behind it (culling it leaves the
    image as the unculled serve's)."""
    jr, tr = jt.TiledReader(tiled["plain"]), tt.TiledReader(tiled["plain"])
    for seed in (3, 4):
        vms, Kms = _cameras(3, seed)
        for margin in (0.0, 0.02, 0.5):
            assert ts.visible_bricks(tr, vms, Kms, SIZE, SIZE, margin=margin) == \
                js.visible_bricks(jr, vms, Kms, SIZE, SIZE, margin=margin)
    w2c = look_at_w2c(np.array([-0.1, -0.1, -0.1]), np.array([-0.6, -0.6, -0.6]))
    f = 1.2 * SIZE
    K = np.array([[f, 0, SIZE / 2], [0, f, SIZE / 2], [0, 0, 1.0]])
    vms, Kms = w2c[None].astype(np.float32), K[None].astype(np.float32)
    sel = ts.visible_bricks(tr, vms, Kms, SIZE, SIZE, margin=0.02)
    assert sel == js.visible_bricks(jr, vms, Kms, SIZE, SIZE, margin=0.02) == [0]
    kw = dict(width=SIZE, height=SIZE, bucket=64, device="cpu", **RASTER)
    culled, _, _, _ = ts.serve_tiled_frame(tiled["plain"], vms, Kms, margin=0.02, **kw)
    full, _, _, _ = ts.serve_tiled_frame(tiled["plain"], vms, Kms, bricks=range(len(tr)),
                                         **kw)
    np.testing.assert_allclose(culled.numpy(), full.numpy(), atol=1e-6)


def _sequence(rng, predict=False, n1=None, signal_motion=True):
    """A J=5 56-channel sequence (I P P, or I P with ``n1`` voxels in frame
    1) coded by the JAX SequenceCodec, with its normative decode."""
    side = 2**DEPTH
    base = _positions(np.unique(morton_codes_np(rng.integers(2, side - 4, (1600, 3)),
                                                DEPTH))[:300])
    attrs = _gs_attrs(rng, len(base))
    if n1 is None:
        positions = [np.clip(base + s, 0, side - 1) for s in ([0, 0, 0], [1, 0, -1], [2, 1, 0])]
        attr_seq = [attrs] * 3
        bucket = 64
    else:
        positions = [base, np.clip(base[:n1] + [1, 0, 0], 0, side - 1)]
        attr_seq = [attrs, attrs[:n1]]
        bucket = 512
    frames = [jp.prepare_voxel_frame(p, a, DEPTH, bucket=bucket, dtype=jnp.float32)
              for p, a in zip(positions, attr_seq)]
    kw = dict(predict=True, predict_impl="host") if predict else {}
    sc = SequenceCodec(DEPTH, gop=8, adaptive=False, dtype=jnp.float32,
                       signal_motion=signal_motion, **kw)
    streams, _ = sc.encode_sequence(frames, steps=STEP)
    return positions, frames, streams, sc


@pytest.mark.parametrize("kind", ["ip", "predict", "cross_size"])
def test_serve_sequence_matches_jax(tmp_path, kind):
    """I/P playback with the reconstruction on the device: each frame within
    2e-4 (1e-3 predicted) of JAX ``serve_sequence`` and of the render of the
    normative ``SequenceCodec.decode_sequence``; the port reads the .r3ts
    file, the JAX package the stream list."""
    tol = SEQ_PREDICT_TOL if kind == "predict" else SEQ_TOL
    positions, frames, streams, sc = _sequence(
        np.random.default_rng(2), predict=kind == "predict",
        n1=130 if kind == "cross_size" else None)
    assert not streams[0].inter and all(s.inter for s in streams[1:])
    path = tmp_path / "seq.r3ts"
    write_sequence(path, streams)
    width = float(frames[0].width)
    vms, Kms = _cameras(2, center=np.asarray(frames[0].vmin) + width / 2, radius=0.7 * width)
    J = list(js.serve_sequence(streams, jnp.asarray(vms), jnp.asarray(Kms),
                               jnp.ones(3, jnp.float32), width=SIZE, height=SIZE,
                               positions=positions, bucket=64, **RASTER))
    T = list(ts.serve_sequence(str(path), vms, Kms, np.ones(3), width=SIZE, height=SIZE,
                               positions=lambda i: positions[i], bucket=64, device="cpu",
                               **RASTER))
    assert len(T) == len(J) == len(frames)
    recons = sc.decode_sequence(streams, frames)
    vs = frames[0].width / 2**DEPTH
    for (ji, jd, _), (ti, td, _), frame, rec in zip(J, T, frames, recons):
        _not_blank(ti.numpy())
        assert _max_diff(ti.numpy(), np.asarray(ji)) <= tol
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        full = np.zeros((frame.codes.shape[0], rec.shape[1]), np.float32)
        full[:frame.n_voxels] = rec
        scene = ts._scene_from_attrs(torch.as_tensor(full), torch.as_tensor(
            np.array(frame.codes)), torch.as_tensor(np.array(frame.weights)), vs,
            np.asarray(frame.vmin), DEPTH)
        ref, _, _ = ts._render_scene_views(scene, vms, Kms, None, width=SIZE, height=SIZE,
                                           **RASTER)
        assert _max_diff(ti.numpy(), ref.numpy()) <= tol


def test_serve_sequence_progressive_matches_jax():
    """progressive=K: K = n reproduces the full serve, a small K is a coarse
    preview within 5e-5 of the JAX package's; inter sequences refused with
    JAX's message."""
    rng = np.random.default_rng(4)
    pos = _positions(np.unique(morton_codes_np(rng.integers(0, 2**DEPTH, (1200, 3)),
                                               DEPTH))[:250])
    n = len(pos)
    frame = jp.prepare_voxel_frame(pos, _gs_attrs(rng, n), DEPTH, bucket=64,
                                   dtype=jnp.float32)
    stream = jp.AttributeCodec(DEPTH, dtype=jnp.float32).encode(frame, STEP).stream
    vms, Kms = _cameras(2)

    def one(mod, progressive, streams=(stream,), positions=(pos,)):
        kw = dict(width=SIZE, height=SIZE, positions=list(positions), bucket=64,
                  progressive=progressive, **RASTER)
        if mod is ts:
            out = ts.serve_sequence([s.to_bytes() for s in streams], vms, Kms,
                                    device="cpu", **kw)
            return [x[0].numpy() for x in out]
        return [np.asarray(x[0]) for x in js.serve_sequence(
            list(streams), jnp.asarray(vms), jnp.asarray(Kms), **kw)]

    full = one(ts, 0)[0]
    np.testing.assert_array_equal(one(ts, n)[0], full)
    coarse = one(ts, n // 8)[0]
    assert _max_diff(coarse, one(js, n // 8)[0]) <= PLAIN_TOL
    assert _max_diff(coarse, full) > 1e-4
    streams, _ = SequenceCodec(DEPTH, gop=8, adaptive=False, dtype=jnp.float32) \
        .encode_sequence([frame, frame], steps=STEP)
    msgs = []
    for mod in (js, ts):
        with pytest.raises(ValueError, match="all-intra") as e:
            one(mod, 32, streams, (pos, pos))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_serve_sequence_refusals_match_jax():
    """A v2 derived-motion stream and an inter frame with no predecessor:
    the JAX package's errors and messages."""
    positions, frames, streams, _ = _sequence(np.random.default_rng(5), signal_motion=False)
    assert streams[1].inter and streams[1].motion is None
    vms, Kms = _cameras(1)
    kw = dict(width=SIZE, height=SIZE, bucket=64, **RASTER)
    for sub, pos, err, match in ((streams, positions, NotImplementedError, "derived-motion"),
                                 (streams[1:], positions[1:], ValueError,
                                  "no frame precedes")):
        with pytest.raises(err, match=match) as ej:
            list(js.serve_sequence(sub, jnp.asarray(vms), jnp.asarray(Kms), positions=pos,
                                   **kw))
        with pytest.raises(err, match=match) as et:
            list(ts.serve_sequence([s.to_bytes() for s in sub], vms, Kms, positions=pos,
                                   device="cpu", **kw))
        assert str(et.value) == str(ej.value)


def test_mesh_serving_names_item_18(served, tiled):
    """Sharded serving runs: ``serve_views_sharded`` and the ``mesh=``
    branches of ``serve_tiled_frame`` and ``serve_sequence`` over two CPU
    slots give the unsharded images bitwise (3 views, padded to 4)
    (``tests/test_torch_sharded_serving.py`` holds them against the JAX
    package)."""
    from raht3dgs_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(2, devices=[torch.device("cpu")] * 2)
    vms, Kms = _cameras(3)
    kw = dict(width=SIZE, height=SIZE, **RASTER)
    tf, p = served["tf"], served["plain"]
    args = (p["vals_T"], p["t_inv"], STEP, tf.codes, tf.weights, served["vs"], VMIN, vms, Kms)
    got = ts.serve_views_sharded(*args, mesh=mesh, depth=DEPTH, **kw)
    for a, b in zip(got, ts.serve_frame(*args, depth=DEPTH, **kw)):
        assert torch.equal(a, b)
    got = ts.serve_tiled_frame(tiled["plain"], vms, Kms, bucket=64, margin=4.0, mesh=mesh,
                               **kw)
    want = ts.serve_tiled_frame(tiled["plain"], vms, Kms, bucket=64, margin=4.0,
                                device="cpu", **kw)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    stream = tbs.FrameStream.from_bytes(p["stream"].to_bytes())
    pos = [_positions(np.asarray(served["jf"].codes)[:stream.n_voxels])]
    seq = list(ts.serve_sequence([stream], vms, Kms, positions=pos, bucket=64, mesh=mesh,
                                 **kw))
    alone = list(ts.serve_sequence([stream], vms, Kms, positions=pos, bucket=64,
                                   device="cpu", **kw))
    for a, b in zip(seq[0], alone[0]):
        assert torch.equal(a, b)
