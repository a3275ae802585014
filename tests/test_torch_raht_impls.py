"""The port's other forward transforms, golden replay, span options and
crosscheck harness against the JAX package's, on the same seeded input.

Tolerances: the level loops (``dense``, ``compact``, ``scan``) give the
JAX package's structure and orders bitwise and its coefficients within
1e-12 (XLA:CPU fuses some multiply-adds, the port does not); within the
port ``compact`` is bitwise ``dense``. ``golden`` is bitwise an in-test
torch replication of the reference butterfly and within 1e-9 of
``dense``. The tiered nearest->= scans are bitwise the flat ones; the
``fill`` inverse is within 1e-4 of ``chain`` (float32).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import unique_voxel_cloud
from raht3dgs_tpu import crosscheck as jcc
from raht3dgs_tpu.models import pipeline as jp
from raht3dgs_tpu.ops import prelude as jpre, raht as jr, raht_compact as jrc
from raht3dgs_tpu.ops import raht_scan as jrs, raht_span as js
from raht3dgs_tpu_torch import crosscheck as cc
from raht3dgs_tpu_torch.codec.bitstream import FrameStream
from raht3dgs_tpu_torch.models import pipeline as tp
from raht3dgs_tpu_torch.ops import morton as tm, prelude as pre, raht as tr
from raht3dgs_tpu_torch.ops import raht_compact as trc, raht_scan as trs, raht_span as ts
from raht3dgs_tpu_torch.ops.reorder import inverse_permutation, ragft_order

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=None):
    t = torch.as_tensor(np.array(x))
    return t if dtype is None else t.to(dtype)


def _dense(codes, attrs, depth, weights=None):
    w = np.ones(len(codes)) if weights is None else weights
    return tr.raht_forward(_t(codes), _t(attrs, F64), _t(w, F64), depth)


def _jdense(codes, attrs, depth, weights=None):
    w = np.ones(len(codes)) if weights is None else weights
    return jr.raht_forward(jnp.asarray(codes), jnp.asarray(attrs, dtype=jnp.float64),
                           jnp.asarray(w, dtype=jnp.float64), depth)


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


def _padded(codes, attrs, depth, pad):
    n = len(codes)
    n_tot = n + pad
    codes_p = np.concatenate([codes, tm.pad_code(depth, n_tot, torch.arange(n, n_tot))
                              .numpy().astype(codes.dtype)])
    attrs_p = np.concatenate([attrs, np.zeros((pad, attrs.shape[1]))])
    return codes_p, attrs_p, np.concatenate([np.ones(n), np.zeros(pad)])


# -- dense (tests/test_raht.py's cases) --------------------------------------------


@pytest.mark.parametrize("depth,n", [(3, 50), (5, 400), (8, 1500)])
def test_forward_matches_list_reference(rng, depth, n):
    _, codes, attrs = unique_voxel_cloud(rng, n, depth)
    res = _dense(codes, attrs, depth)
    Lists, Flags, weights, _ = pre.prelude(codes, 3 * depth)
    T_ref, w_ref = pre.raht_forward_lists(attrs, Lists, Flags, weights)
    np.testing.assert_allclose(res.coeffs.numpy(), T_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(res.weights.numpy(), w_ref)
    want = _jdense(codes, attrs, depth)
    _close(res.coeffs.numpy(), want.coeffs)
    for f in ("drop_level", "subtree_w", "node_weights"):
        np.testing.assert_array_equal(getattr(res.structure, f).numpy(),
                                      np.asarray(getattr(want.structure, f)), err_msg=f)


def test_inverse_matches_list_reference(rng):
    depth, n = 5, 300
    _, codes, attrs = unique_voxel_cloud(rng, n, depth)
    res = _dense(codes, attrs, depth)
    Lists, Flags, weights, _ = pre.prelude(codes, 3 * depth)
    C_ref = pre.raht_inverse_lists(res.coeffs.numpy(), Lists, Flags, weights)
    C = tr.raht_inverse(res.coeffs, res.structure, depth)
    np.testing.assert_allclose(C.numpy(), C_ref, rtol=1e-12, atol=1e-12)
    jres = _jdense(codes, attrs, depth)
    _close(C.numpy(), jr.raht_inverse(jres.coeffs, jres.structure, depth))


@pytest.mark.parametrize("depth,n", [(4, 128), (10, 2000)])
def test_roundtrip_lossless(rng, depth, n):
    _, codes, attrs = unique_voxel_cloud(rng, n, depth)
    res = _dense(codes, attrs, depth)
    C = tr.raht_inverse(res.coeffs, res.structure, depth)
    np.testing.assert_allclose(C.numpy(), attrs, rtol=1e-5, atol=1e-8)


def test_orthonormal_energy_preserved(rng):
    depth, n = 6, 777
    _, codes, attrs = unique_voxel_cloud(rng, n, depth)
    res = _dense(codes, attrs, depth)
    np.testing.assert_allclose(np.linalg.norm(res.coeffs.numpy(), axis=0),
                               np.linalg.norm(attrs, axis=0), rtol=1e-10)


def test_dc_identity(rng):
    depth, n = 6, 512
    _, codes, attrs = unique_voxel_cloud(rng, n, depth)
    attrs = np.abs(attrs)
    T = _dense(codes, attrs, depth).coeffs.numpy()
    np.testing.assert_allclose(T.max(axis=0), np.sqrt(n) * attrs.mean(axis=0), rtol=1e-8)


def test_padding_is_invisible(rng):
    depth, n, pad = 5, 300, 212
    _, codes, attrs = unique_voxel_cloud(rng, n, depth)
    res = _dense(codes, attrs, depth)
    codes_p, attrs_p, w_p = _padded(codes, attrs, depth, pad)
    res_p = _dense(codes_p, attrs_p, depth, w_p)
    np.testing.assert_array_equal(res_p.coeffs.numpy()[:n], res.coeffs.numpy())
    np.testing.assert_array_equal(res_p.weights.numpy()[:n], res.weights.numpy())
    np.testing.assert_array_equal(res_p.structure.drop_level.numpy()[:n],
                                  res.structure.drop_level.numpy())
    C_p = tr.raht_inverse(res_p.coeffs, res_p.structure, depth).numpy()
    np.testing.assert_allclose(C_p[:n], attrs, rtol=1e-5, atol=1e-8)
    assert not np.isnan(C_p).any()


def test_structure_pass_matches_forward(rng):
    depth, n = 5, 300
    _, codes, attrs = unique_voxel_cloud(rng, n, depth)
    res = _dense(codes, attrs, depth)
    st = tr.raht_structure(_t(codes), torch.ones(n, dtype=F64), depth)
    jst = jr.raht_structure(jnp.asarray(codes), jnp.ones(n, dtype=jnp.float64), depth)
    for f in ("drop_level", "subtree_w", "node_weights"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), getattr(res.structure, f).numpy())
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(jst, f)))


@pytest.mark.parametrize("depth,n", [(3, 60), (5, 400), (8, 1200)])
def test_ragft_order_matches_reference(rng, depth, n):
    _, codes, _ = unique_voxel_cloud(rng, n, depth)
    st = tr.raht_structure(_t(codes), torch.ones(n, dtype=F64), depth)
    order = ragft_order(st.drop_level).numpy()
    _, _, _, order_ref = pre.prelude(codes, 3 * depth)
    np.testing.assert_array_equal(order, order_ref)
    np.testing.assert_array_equal(order_ref, jpre.prelude(codes, 3 * depth)[3])


def test_ragft_order_with_padding(rng):
    depth, n, pad = 5, 333, 179
    _, codes, attrs = unique_voxel_cloud(rng, n, depth)
    st = tr.raht_structure(_t(codes), torch.ones(n, dtype=F64), depth)
    order_ref = ragft_order(st.drop_level).numpy()
    codes_p, _, w_p = _padded(codes, attrs, depth, pad)
    st_p = tr.raht_structure(_t(codes_p), _t(w_p, F64), depth)
    order_p = ragft_order(st_p.drop_level).numpy()
    np.testing.assert_array_equal(order_p[order_p < n], order_ref)


def test_inverse_permutation(rng):
    perm = rng.permutation(100)
    inv = inverse_permutation(torch.as_tensor(perm)).numpy()
    np.testing.assert_array_equal(perm[inv], np.arange(100))


def test_multiplicity_weights(rng):
    depth = 4
    _, codes, attrs = unique_voxel_cloud(rng, 64, depth)
    reps = rng.integers(1, 5, size=len(codes)).astype(np.float64)
    res = _dense(codes, attrs, depth, reps)
    T = res.coeffs.numpy()
    dc = T[np.argmax(np.abs(T[:, 0]))]
    want = (np.sqrt(reps)[:, None] * attrs).sum(axis=0) / np.sqrt(reps.sum())
    np.testing.assert_allclose(dc, want, rtol=1e-10)
    C = tr.raht_inverse(res.coeffs, res.structure, depth)
    np.testing.assert_allclose(C.numpy(), attrs, rtol=1e-8, atol=1e-8)
    _close(T, _jdense(codes, attrs, depth, reps).coeffs)


@pytest.mark.parametrize("depth,n,bucket", [(10, 3000, 4096), (18, 1500, 2048)])
def test_dense_padded_frames_match_jax(depth, n, bucket):
    """The int32 and int64 tiers on codec frames (pads, f64 and f32)."""
    r = np.random.default_rng(depth)
    pts, _, attrs = unique_voxel_cloud(r, n, depth)
    for jdt, tol in ((jnp.float64, 1e-12), (jnp.float32, 1e-5)):
        jf = jp.prepare_voxel_frame(pts, attrs, depth, bucket=bucket, dtype=jdt)
        tf = tp.voxel_frame_from_arrays(np.array(jf.codes), np.array(jf.attributes),
                                        np.array(jf.weights), jf.n_voxels, depth, jf.vmin,
                                        jf.width, device="cpu")
        want = jr.raht_forward(jf.codes, jf.attributes, jf.weights, depth)
        got = tr.raht_forward(tf.codes, tf.attributes, tf.weights, depth)
        _close(got.coeffs.numpy(), want.coeffs, tol)
        np.testing.assert_array_equal(got.structure.drop_level.numpy(),
                                      np.asarray(want.structure.drop_level))
        rec = tr.raht_inverse(got.coeffs, got.structure, depth).numpy()[:n]
        _close(rec, jr.raht_inverse(want.coeffs, want.structure, depth)[:n], tol)


# -- compact and scan -------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["compact", "scan"])
@pytest.mark.parametrize("depth,n", [(3, 60), (5, 500), (8, 2000)])
def test_level_loop_matches_dense(rng, impl, depth, n):
    _, codes, attrs = unique_voxel_cloud(rng, n, depth)
    fn = {"compact": trc.raht_forward_compact, "scan": trs.raht_forward_scan}[impl]
    jfn = {"compact": jrc.raht_forward_compact, "scan": jrs.raht_forward_scan}[impl]
    a = _dense(codes, attrs, depth)
    b = fn(_t(codes), _t(attrs, F64), torch.ones(n, dtype=F64), depth)
    if impl == "compact":   # the same pairing and arithmetic: bitwise
        np.testing.assert_array_equal(b.coeffs.numpy(), a.coeffs.numpy())
    _close(b.coeffs.numpy(), a.coeffs.numpy())
    for f in ("drop_level", "subtree_w", "node_weights"):
        np.testing.assert_array_equal(getattr(b.structure, f).numpy(),
                                      getattr(a.structure, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(b.weights.numpy(), a.weights.numpy())
    want = jfn(jnp.asarray(codes), jnp.asarray(attrs, dtype=jnp.float64),
               jnp.ones(n, dtype=jnp.float64), depth)
    _close(b.coeffs.numpy(), want.coeffs)
    np.testing.assert_array_equal(b.structure.drop_level.numpy(),
                                  np.asarray(want.structure.drop_level))


@pytest.mark.parametrize("impl", ["compact", "scan"])
def test_level_loop_with_padding_and_inverse(rng, impl):
    depth, n, pad = 5, 311, 201
    _, codes, attrs = unique_voxel_cloud(rng, n, depth)
    codes_p, attrs_p, w_p = _padded(codes, attrs, depth, pad)
    fn = {"compact": trc.raht_forward_compact, "scan": trs.raht_forward_scan}[impl]
    a = _dense(codes_p, attrs_p, depth, w_p)
    b = fn(_t(codes_p), _t(attrs_p, F64), _t(w_p, F64), depth)
    _close(b.coeffs.numpy()[:n], a.coeffs.numpy()[:n])
    np.testing.assert_array_equal(b.structure.drop_level.numpy(),
                                  a.structure.drop_level.numpy())
    C = tr.raht_inverse(b.coeffs, b.structure, depth).numpy()
    np.testing.assert_allclose(C[:n], attrs, rtol=1e-5, atol=1e-8)
    assert not np.isnan(C).any()


def test_compact_inverse_roundtrip(rng):
    depth, n = 6, 700
    _, codes, attrs = unique_voxel_cloud(rng, n, depth)
    res = trc.raht_forward_compact(_t(codes), _t(attrs, F64), torch.ones(n, dtype=F64), depth)
    C = tr.raht_inverse(res.coeffs, res.structure, depth)
    np.testing.assert_allclose(C.numpy(), attrs, rtol=1e-5, atol=1e-8)


def test_forward_impl_names():
    assert tr.get_forward_impl("dense") is tr.raht_forward
    assert tr.get_forward_impl("compact") is trc.raht_forward_compact
    assert tr.get_forward_impl("scan") is trs.raht_forward_scan
    assert tr.get_forward_impl("span") is ts.raht_forward_span
    with pytest.raises(ValueError, match="unknown RAHT impl"):
        tr.get_forward_impl("bogus")


# -- the codec's impl choices -----------------------------------------------------------


@pytest.mark.parametrize("impl", ["dense", "compact", "scan"])
@pytest.mark.parametrize("order_mode", ["ragft", "weight_desc"])
def test_codec_impl_streams_match_jax(impl, order_mode):
    r = np.random.default_rng(1)
    pts, _, attrs = unique_voxel_cloud(r, 1500, 8)   # non-integer attributes
    jf = jp.prepare_voxel_frame(pts, attrs, 8, bucket=2048)
    tf = tp.voxel_frame_from_arrays(np.array(jf.codes), np.array(jf.attributes),
                                    np.array(jf.weights), jf.n_voxels, 8, jf.vmin, jf.width,
                                    device="cpu")
    tc = tp.AttributeCodec(8, impl=impl, order_mode=order_mode, device="cpu")
    jb = jp.AttributeCodec(8, impl=impl, order_mode=order_mode).encode(jf, 4.0).stream.to_bytes()
    tb = tc.encode(tf, 4.0).stream.to_bytes()
    assert tb == jb
    span = tp.AttributeCodec(8, order_mode=order_mode, device="cpu")
    assert span.encode(tf, 4.0).stream.to_bytes() == tb
    c_i, o_i, s_i, _ = tc.transform(tf)
    c_s, o_s, s_s, _ = span.transform(tf)
    assert torch.equal(o_i, o_s) and torch.equal(s_i.drop_level, s_s.drop_level)
    _close(c_i.numpy(), c_s.numpy(), 1e-9)
    rec, _ = span.decode(FrameStream.from_bytes(tb), tf.codes, tf.weights)
    assert np.abs(rec - attrs).max() <= 4.0


def test_weight_desc_order_consistent_across_impls(rng):
    depth = 6
    pts, codes, attrs = unique_voxel_cloud(rng, 900, depth)
    w = rng.uniform(0.1, 3.0, len(pts))
    frame = tp.prepare_voxel_frame(pts.astype(np.int64), attrs, depth, bucket=1024,
                                   dtype=torch.float32, weights=w, device="cpu")
    ref = frame.attributes.numpy()[:frame.n_voxels]
    for impl in ("dense", "span", "compact", "scan"):
        codec = tp.AttributeCodec(depth, dtype=torch.float32, order_mode="weight_desc",
                                  impl=impl, device="cpu")
        enc = codec.encode(frame, steps=1.0)
        rec, _ = codec.decode(enc.stream, frame.codes, frame.weights)
        assert np.abs(rec - ref).max() < 1.5, impl


def test_impl_default_reads_environment_per_codec(monkeypatch):
    monkeypatch.setenv("RAHT3DGS_RAHT_IMPL", "dense")
    assert tp.AttributeCodec(6, device="cpu").impl == "dense"
    monkeypatch.setenv("RAHT3DGS_RAHT_IMPL", "compact")
    assert tp.AttributeCodec(6, device="cpu").impl == "compact"
    assert tp.AttributeCodec(6, impl="span", device="cpu").impl == "span"
    monkeypatch.delenv("RAHT3DGS_RAHT_IMPL")
    assert tp.AttributeCodec(6, device="cpu").impl == "span"
    with pytest.raises(ValueError, match="unknown impl"):
        tp.AttributeCodec(6, impl="bogus", device="cpu")


# -- golden -------------------------------------------------------------------------------


def _golden_frame(rng, n=4000, depth=9):
    pts = rng.integers(0, 2**depth, size=(2 * n, 3))
    codes = np.unique(tm.morton_codes_np(pts, depth))[:n]
    V = tm.morton_decode(torch.as_tensor(codes), depth).numpy().astype(np.int64)
    rgb = np.clip(np.round(V / 2**depth * 255.0 + rng.normal(0, 8, size=V.shape)), 0, 255)
    return V, rgb, codes


def _torch_reference(X_np, Lists, Flags, weights, inverse):
    """The reference butterfly (forward or inverse), replicated in torch."""
    T = torch.from_numpy(X_np.copy())
    levels = range(len(Flags))
    for j in (reversed(levels) if inverse else levels):
        flag = torch.from_numpy(Flags[j])
        right = torch.cat([torch.tensor([False]), flag[:-1]])
        i0 = torch.from_numpy(Lists[j])[flag]
        i1 = torch.from_numpy(Lists[j])[right]
        if i0.numel() == 0:
            continue
        w0 = torch.from_numpy(weights[j])[flag].to(F64)
        w1 = torch.from_numpy(weights[j])[right].to(F64)
        a = torch.sqrt(w0 / (w0 + w1)).unsqueeze(1)
        b = torch.sqrt(w1 / (w0 + w1)).unsqueeze(1)
        x0 = T.index_select(0, i0)
        x1 = T.index_select(0, i1)
        e0 = i0.unsqueeze(1).expand(-1, T.shape[1])
        e1 = i1.unsqueeze(1).expand(-1, T.shape[1])
        if inverse:
            T.scatter_(0, e0, a * x0 - b * x1)
            T.scatter_(0, e1, b * x0 + a * x1)
        else:
            T.scatter_(0, e0, a * x0 + b * x1)
            T.scatter_(0, e1, -b * x0 + a * x1)
    return T.numpy()


def test_parity_sqrt_is_torch_cpu_sqrt():
    x = np.arange(1, 200000, dtype=np.float64)
    x = x / (x + 3.0)
    t = torch.sqrt(torch.from_numpy(x)).numpy()
    assert pre.parity_sqrt()(x).tobytes() == t.tobytes()
    assert pre.parity_sqrt()(x).tobytes() == jpre.parity_sqrt()(x).tobytes()
    assert pre.morton_codes_np is tm.morton_codes_np


def test_prelude_matches_jax(rng):
    for depth, n in [(1, 1), (4, 60), (9, 3000)]:
        _, codes, _ = unique_voxel_cloud(rng, n, depth)
        for a, b in zip(pre.prelude(codes, 3 * depth), jpre.prelude(codes, 3 * depth)):
            if isinstance(a, list):
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_array_equal(a, b)


def test_golden_forward_inverse_bitwise_vs_torch(rng):
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv_parity

    depth = 9
    V, rgb, codes = _golden_frame(rng, 4000, depth)
    yuv = rgb_to_yuv_parity(rgb)
    Lists, Flags, weights, order = pre.prelude(codes, 3 * depth)
    T, _ = pre.raht_forward_lists(yuv, Lists, Flags, weights, sqrt_fn=pre.parity_sqrt())
    T_ref = _torch_reference(yuv, Lists, Flags, weights, inverse=False)
    assert T.tobytes() == T_ref.tobytes()
    jT, _ = jpre.raht_forward_lists(yuv, Lists, Flags, weights, sqrt_fn=jpre.parity_sqrt())
    assert T.tobytes() == jT.tobytes()
    q = np.floor(T_ref / 4.0 + 0.5) * 4.0
    rec = pre.raht_inverse_lists(q, Lists, Flags, weights, sqrt_fn=pre.parity_sqrt())
    assert rec.tobytes() == _torch_reference(q, Lists, Flags, weights, inverse=True).tobytes()


def test_golden_codec_matches_device_impls_and_jax(rng):
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv_parity

    depth = 8
    V, rgb, _ = _golden_frame(rng, 2500, depth)
    yuv = rgb_to_yuv_parity(rgb)
    frame = tp.prepare_voxel_frame(V, yuv, depth, device="cpu")
    g = tp.AttributeCodec(depth, impl="golden", device="cpu")
    d = tp.AttributeCodec(depth, impl="dense", device="cpu")
    cg, og, sg, _ = g.transform(frame)
    cd, od, _, _ = d.transform(frame)
    assert sg is None and cg.device == frame.codes.device
    n = frame.n_voxels
    np.testing.assert_allclose(cg.numpy()[:n], cd.numpy()[:n], rtol=1e-9, atol=1e-9)
    od_pl = od.numpy()[np.argsort(od.numpy() >= n, kind="stable")]
    np.testing.assert_array_equal(og.numpy()[:n], od_pl[:n])
    enc = g.encode(frame, 2.0, coeffs=cg, order=og)
    rec, _ = g.decode(enc.stream, frame.codes, frame.weights)
    assert np.abs(rec - yuv).max() <= 2.0 + 1e-9
    rec_d, _ = d.decode(enc.stream, frame.codes, frame.weights)
    np.testing.assert_allclose(rec, rec_d, rtol=1e-9, atol=1e-9)
    # the JAX package's golden codec: the same bytes and reconstruction
    jf = jp.prepare_voxel_frame(V, yuv, depth)
    jg = jp.AttributeCodec(depth, impl="golden")
    blob = jg.encode(jf, 2.0).stream.to_bytes()
    assert enc.stream.to_bytes() == blob
    rec_j, _ = jg.decode(jg.encode(jf, 2.0).stream, jf.codes, jf.weights)
    assert rec.tobytes() == np.asarray(rec_j).tobytes()


def test_golden_progressive_prefix(rng):
    depth = 8
    V, rgb, _ = _golden_frame(rng, 2000, depth)
    frame = tp.prepare_voxel_frame(V, rgb.astype(np.float64), depth, device="cpu")
    g = tp.AttributeCodec(depth, impl="golden", device="cpu")
    enc = g.encode(frame, 1.0)
    full, _ = g.decode(enc.stream, frame.codes, frame.weights)
    again, _ = g.decode_progressive(enc.stream, frame.codes, frame.weights, frame.n_voxels)
    np.testing.assert_array_equal(full, again)
    coarse, _ = g.decode_progressive(enc.stream, frame.codes, frame.weights,
                                     frame.n_voxels // 4)
    assert coarse.shape == full.shape and np.mean((coarse - full) ** 2) > 0
    jf = jp.prepare_voxel_frame(V, rgb.astype(np.float64), depth)
    want, _ = jp.AttributeCodec(depth, impl="golden").decode_progressive(
        enc.stream, jf.codes, jf.weights, frame.n_voxels // 4)
    assert coarse.tobytes() == np.asarray(want).tobytes()


def test_golden_mode_guards(rng):
    for kw, match in ((dict(order_mode="weight_desc"), "ragft"),
                      (dict(quant_mode="deadzone"), "mid"), (dict(predict=True), "predicted")):
        with pytest.raises(ValueError, match=match) as te:
            tp.AttributeCodec(8, impl="golden", device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            jp.AttributeCodec(8, impl="golden", **kw)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="depth"):
        tp.AttributeCodec(21, impl="golden", device="cpu")
    depth = 6
    V, rgb, _ = _golden_frame(rng, 300, depth)
    frame = tp.prepare_voxel_frame(V, rgb.astype(np.float64), depth, device="cpu")
    frame.weights = frame.weights.clone()
    frame.weights[0] = 2.0
    g = tp.AttributeCodec(depth, impl="golden", device="cpu")
    with pytest.raises(ValueError, match="multiplicity"):
        g.transform(frame)
    uframe = tp.prepare_voxel_frame(V, rgb.astype(np.float64), depth, device="cpu")
    enc = tp.AttributeCodec(depth, device="cpu").encode(uframe, 2.0)
    with pytest.raises(ValueError, match="multiplicity"):
        g.decode(enc.stream, frame.codes, frame.weights)


def test_golden_colour_frame_rows_match_jax(rng):
    from raht3dgs_tpu.models import color_codec as jcol
    from raht3dgs_tpu_torch.models import color_codec as tcol

    V, rgb, _ = _golden_frame(rng, 800, 7)
    t = tcol.encode_color_frame(V, rgb, depth=7, steps=(2.0, 8.0),
                                codec=tp.AttributeCodec(7, impl="golden", device="cpu"))
    j = jcol.encode_color_frame(V, rgb, depth=7, steps=(2.0, 8.0),
                                codec=jp.AttributeCodec(7, impl="golden"))
    for a, b in zip(t, j):
        assert (a.bpp, a.stream_bytes) == (b.bpp, b.stream_bytes)
        assert a.psnr == b.psnr


# -- crosscheck (tests/test_crosscheck.py's cases) ----------------------------------------


def _matlab_style_dump(path, codes, depth, weights_override=None):
    Lists, Flags, weights, _ = pre.prelude(codes, 3 * depth)
    cc.save_lists(path, ListC=[l + 1 for l in Lists],
                  FlagsC=[f.astype(np.float64) for f in Flags],
                  weightsC=weights_override or weights)
    return Lists, Flags, weights


def test_prelude_crosscheck_passes(tmp_path, rng):
    depth = 5
    _, codes, _ = unique_voxel_cloud(rng, 300, depth)
    _matlab_style_dump(tmp_path / "params.mat", codes, depth)
    report = cc.crosscheck_prelude(codes, depth, tmp_path / "params.mat")
    assert report.ok, str(report)
    assert str(report) == str(jcc.crosscheck_prelude(codes, depth, tmp_path / "params.mat"))


def test_prelude_crosscheck_detects_corruption(tmp_path, rng):
    depth = 5
    _, codes, _ = unique_voxel_cloud(rng, 300, depth)
    Lists, Flags, weights = _matlab_style_dump(tmp_path / "p.mat", codes, depth)
    bad = [w.copy() for w in weights]
    bad[2][0] += 1
    _matlab_style_dump(tmp_path / "bad.mat", codes, depth, bad)
    report = cc.crosscheck_prelude(codes, depth, tmp_path / "bad.mat")
    assert not report.ok
    assert any("weights[2]" in str(r) for r in report.results if not r.ok)


def test_coefficient_crosscheck(tmp_path, rng):
    depth = 4
    _, codes, attrs = unique_voxel_cloud(rng, 200, depth)
    Lists, Flags, weights, _ = pre.prelude(codes, 3 * depth)
    T, _ = pre.raht_forward_lists(attrs, Lists, Flags, weights)
    cc.save_mat(T, tmp_path / "coeff.mat")
    assert cc.crosscheck_coefficients(T, tmp_path / "coeff.mat").ok
    assert not cc.crosscheck_coefficients(T + 1e-9, tmp_path / "coeff.mat").ok
    # the dense transform's coefficients pass against the golden dump
    dense = _dense(codes, attrs, depth)
    rep = cc.crosscheck_coefficients(dense.coeffs.numpy(), tmp_path / "coeff.mat",
                                     weights=dense.weights.numpy(),
                                     weights_mat=pre.raht_forward_lists(
                                         attrs, Lists, Flags, weights)[1])
    assert rep.ok, str(rep)


def test_compare_tensor_shapes():
    r = cc.compare_tensor("x", np.zeros(3), np.zeros(4))
    assert not r.ok and "shape" in r.detail
    assert str(r) == str(jcc.compare_tensor("x", np.zeros(3), np.zeros(4)))
    a = cc.compare_level_lists("L", [np.arange(3)], [np.arange(1, 4)], index_like=True)
    assert all(x.ok for x in a)


# -- the span options ------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [10, 18, 21])
def test_nearest_ge_tiered_matches_flat(rng, depth):
    N = 8192
    _, codes, _ = unique_voxel_cloud(rng, 6000, depth)
    n = len(codes)
    codes_p = torch.cat([tm.codes_from_host(codes, depth, device="cpu")
                         .to(tm.code_dtype(depth, N)),
                         tm.pad_code(depth, N, torch.arange(n, N))])
    levels = tr.num_levels(depth, N)
    B = torch.cat([torch.full((1,), levels + 1, dtype=torch.int32),
                   ts._msb(codes_p[1:] ^ codes_p[:-1], levels)])
    n_vals = levels + 2
    assert ts._nge_tier_plan(N, n_vals) == js._nge_tier_plan(N, n_vals) is not None
    w = torch.as_tensor(rng.integers(1, 4, N).astype(np.float64))
    W = torch.cat([torch.zeros(1, dtype=F64), torch.cumsum(w, 0)])
    for args in ((B, n_vals), (B, n_vals, W)):
        for a, b in zip(ts._nearest_ge_tiered(*args), ts._nearest_ge_flat(*args)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    # and the JAX package's tiered scans, on its uint64 values
    ju = jnp.asarray(tm.codes_to_host(codes_p, depth))
    jB = jnp.concatenate([jnp.full((1,), levels + 1, jnp.int32),
                          js._msb(ju[1:] ^ ju[:-1], levels).astype(jnp.int32)])
    np.testing.assert_array_equal(np.asarray(jB), B.numpy())
    for a, b in zip(ts._nearest_ge_tiered(B, n_vals), js._nearest_ge_tiered(jB, n_vals)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_span_inverse_fill_matches_chain(rng):
    for trial in range(6):
        depth = int(rng.integers(2, 7))
        pts, codes, attrs = unique_voxel_cloud(rng, int(rng.integers(1, 500)), depth)
        n = len(codes)
        pad = int(rng.integers(0, 5))
        codes_p = np.concatenate([codes, tm.pad_code(depth, n + pad, torch.arange(n, n + pad))
                                  .numpy().astype(codes.dtype)])
        attrs_p = np.concatenate([attrs, np.zeros((pad, 3))]).astype(np.float32)
        w = np.concatenate([rng.integers(1, 4, n), np.zeros(pad)]).astype(np.float32)
        c, a, wt = _t(codes_p), _t(attrs_p), _t(w)
        res = ts.raht_forward_span(c, a, wt, depth)
        chain = ts._raht_inverse_span_chain(res.coeffs, c, wt, depth).numpy()
        fill = ts._raht_inverse_span_fill(res.coeffs, c, wt, depth).numpy()
        np.testing.assert_allclose(fill[:n], chain[:n], rtol=0, atol=1e-4)
        np.testing.assert_allclose(fill[:n], attrs_p[:n], rtol=0, atol=1e-3)
        jfill = js._raht_inverse_span_fill(jnp.asarray(res.coeffs.numpy()),
                                           jnp.asarray(codes_p), jnp.asarray(w), depth)
        np.testing.assert_allclose(fill[:n], np.asarray(jfill)[:n], rtol=0, atol=1e-4)


def test_span_inverse_switch_read_per_call(monkeypatch):
    r = np.random.default_rng(3)
    pts, _, attrs = unique_voxel_cloud(r, 700, 21)
    frame = tp.prepare_voxel_frame(pts.astype(np.int64), attrs, 21, bucket=1024,
                                   device="cpu")
    codec = tp.AttributeCodec(21, device="cpu")
    enc = codec.encode(frame, 1.0)
    rec_c, _ = codec.decode(enc.stream, frame.codes, frame.weights)
    monkeypatch.setenv("RAHT3DGS_SPAN_INVERSE", "fill")
    rec_f, _ = codec.decode(enc.stream, frame.codes, frame.weights)
    assert np.abs(rec_f - rec_c).max() < 1e-9 and not np.array_equal(rec_f, rec_c)
    called = []
    monkeypatch.setattr(ts, "_raht_inverse_span_fill",
                        lambda *a: called.append(1) or torch.zeros_like(a[0]))
    ts.raht_inverse_span(*(torch.zeros(4, 1), torch.arange(4), torch.ones(4), 2))
    assert called


def test_span_sums_f64_switch_matches_jax(monkeypatch):
    """RAHT3DGS_SPAN_SUMS=f64 (read at import in both packages; set here on
    the modules): float32 frames take float64 prefix sums."""
    r = np.random.default_rng(4)
    pts, _, attrs = unique_voxel_cloud(r, 3000, 10)
    jf = jp.prepare_voxel_frame(pts, attrs, 10, bucket=4096, dtype=jnp.float32)
    tf = tp.voxel_frame_from_arrays(np.array(jf.codes), np.array(jf.attributes),
                                    np.array(jf.weights), jf.n_voxels, 10, jf.vmin, jf.width,
                                    device="cpu")
    calls = []
    monkeypatch.setattr(ts, "ds_prefix_pack", lambda *a: calls.append(1))
    monkeypatch.setattr(ts, "_SUM_MODE", "f64")
    monkeypatch.setattr(js, "_SUM_MODE", "f64")
    jax.clear_caches()
    try:
        want = js.raht_forward_span(jf.codes, jf.attributes, jf.weights, 10)
        jst = js.raht_structure_span(jf.codes, jf.weights, 10)
    finally:
        monkeypatch.setattr(js, "_SUM_MODE", "ds")
        jax.clear_caches()
    got = ts.raht_forward_span(tf.codes, tf.attributes, tf.weights, 10)
    st = ts.raht_structure_span(tf.codes, tf.weights, 10)
    assert not calls and got.coeffs.dtype == torch.float32
    _close(got.coeffs.numpy(), want.coeffs, 1e-6)
    np.testing.assert_array_equal(st.node_weights.numpy(), np.asarray(jst.node_weights))
    np.testing.assert_array_equal(got.structure.node_weights.numpy(), st.node_weights.numpy())
    rec = ts.raht_inverse_span(got.coeffs, tf.codes, tf.weights, 10).numpy()[:jf.n_voxels]
    assert np.abs(rec - attrs).max() < 1e-3
    assert importlib.import_module("raht3dgs_tpu_torch.ops.raht_span")._use_ds(torch.float64) \
        is False
