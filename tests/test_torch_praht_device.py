"""The port's device predicted-RAHT encoder (``ops/praht_device.py``), run
on the CPU, against the JAX package's HOST encoder, on the fixtures of
``tests/test_praht_device.py``.

The host loop is the decode spec; the device encoder emits the same stream
format by construction. The gate: equal bytes where they are equal; where
a symbol differs, the first difference in stream order must lie where the
host's quantizer input / step is within 1e-9 (float64) / 1e-5 (float32)
of a rounding tie, with the same predict mask. Always: the stream decodes
by the host loop, and the encoder's own reconstruction equals that decode
within 1e-9 / 1e-3 of each channel's range. No difference has been seen on
these fixtures; one would be filed in ROADMAP queue C with its fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import unique_voxel_cloud
from raht3dgs_tpu.models import pipeline as jp
from raht3dgs_tpu.ops import praht as jpr, praht_device as jpd
from raht3dgs_tpu_torch.codec.bitstream import FrameStream
from raht3dgs_tpu_torch.models import pipeline as tp
from raht3dgs_tpu_torch.ops import praht as tpr, praht_device as tpd

_TORCH = {jnp.float64: torch.float64, jnp.float32: torch.float32}


@pytest.fixture(autouse=True)
def _one_thread():
    """The device encoder runs thousands of small ops a step: on the CPU one
    intra-op thread is faster, and does not oversubscribe the cores that
    other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_TIE_TOL = {jnp.float64: 1e-9, jnp.float32: 1e-5}
_REC_TOL = {jnp.float64: 1e-9, jnp.float32: 1e-3}


def _smooth_frame(rng, n=3000, depth=8, d_attr=4, weights=False, dtype=jnp.float64):
    """``tests/test_praht_device.py``'s fixture, in both packages."""
    pts, _, _ = unique_voxel_cloud(rng, n, depth, d_attr=1)
    base = pts[:, 0:1] * 0.3 + pts[:, 1:2] * 0.1
    attrs = np.repeat(base.astype(np.float64), d_attr, axis=1)
    attrs += rng.normal(scale=1.0, size=attrs.shape)
    w = rng.integers(1, 4, size=pts.shape[0]).astype(float) if weights else None
    jf = jp.prepare_voxel_frame(pts.astype(np.int64), attrs, depth, weights=w, dtype=dtype)
    tf = tp.voxel_frame_from_arrays(np.array(jf.codes), np.array(jf.attributes),
                                    np.array(jf.weights), jf.n_voxels, depth, jf.vmin,
                                    jf.width, device="cpu")
    return jf, tf


def _symbols(stream):
    q = np.zeros((stream.n_channels, stream.n_voxels), np.int32)
    tp.decode_entropy_channels(stream, stream.n_voxels, q)
    return q


def _tie_gate(jdt, tf, host: FrameStream, dev: FrameStream, quant_mode="mid", qf=0.3):
    """Equal bytes, or a first symbol difference at a quantization tie of the
    host encoder's own quantizer input (the symbols before it are equal, so
    both loops agree on everything the input depends on)."""
    if host.to_bytes() == dev.to_bytes():
        return
    assert host.predict_mask == dev.predict_mask
    qh, qd = _symbols(host), _symbols(dev)
    diff = np.flatnonzero((qh != qd).any(axis=0))
    i = int(diff[0])
    c = int(np.flatnonzero(qh[:, i] != qd[:, i])[0])
    n = tf.n_voxels
    fdtype = np.float32 if host.dtype32 else np.float64
    codes = tf.codes.numpy()[:n]
    w = tf.weights.numpy()[:n]
    attrs = tf.attributes.numpy()[:n]
    plan = tpr.praht_plan(codes, w, tf.depth, fdtype=fdtype)
    dc, tt_ac = tpr.praht_true_coeffs(plan, attrs)
    step = host.steps[c if host.steps.shape[0] > 1 else 0]
    if i == 0:
        x = dc[0, c]
    else:
        start, d = 1, 1
        while start + plan.levels[d - 1].n_ac <= i:
            start += plan.levels[d - 1].n_ac
            d += 1
        lv = plan.levels[d - 1]
        x = tt_ac[d - 1][i - start, c]
        if host.predict_mask >> (d - 1) & 1:
            _, m_prev, _ = tpr.praht_decode(qh, codes, w, tf.depth, host.steps,
                                            predict_mask=host.predict_mask,
                                            quant_mode=quant_mode, fdtype=fdtype,
                                            lod_depth=d - 1, plan=plan)
            pred = tpr._predict_lv(lv, m_prev, fdtype, "native")
            x = x - tpr._forward_lv(lv, pred * lv.sq, "native")[lv.is_ac][i - start, c]
    u = abs(x) / step + qf if quant_mode == "deadzone" else x / step + 0.5
    assert abs(u - np.round(u)) <= _TIE_TOL[jdt], (i, c, float(x), step)


def _check_rec(jdt, codec, tf, stream, steps):
    """The stream decodes by the host loop, and the encoder's own
    reconstruction equals that decode."""
    dec, _ = codec.decode(FrameStream.from_bytes(stream.to_bytes()), tf.codes, tf.weights)
    _, _, rec = codec.praht_device_step(tf, steps)
    rec = rec[:tf.n_voxels].numpy()
    scale = np.ptp(tf.attributes.numpy()[:tf.n_voxels], axis=0)
    assert np.isfinite(dec).all()
    assert (np.abs(rec - dec) <= _REC_TOL[jdt] * scale).all()


@pytest.mark.parametrize("weights", [False, True])
def test_device_stream_matches_jax_host(rng, weights):
    depth = 8
    jf, tf = _smooth_frame(rng, weights=weights)
    host = jp.AttributeCodec(depth, predict=True, predict_impl="host")
    dev = tp.AttributeCodec(depth, predict=True, predict_impl="device", device="cpu")
    for steps in (1.0, 8.0, [2.0, 2.0, 4.0, 8.0]):
        eh = host.encode(jf, steps).stream
        ed = dev.encode(tf, steps).stream
        assert ed.predict
        _tie_gate(jnp.float64, tf, tp.FrameStream.from_bytes(eh.to_bytes()), ed)
        _check_rec(jnp.float64, dev, tf, ed, steps)
    # prediction must actually engage on this content
    assert host.encode(jf, 1.0).stream.predict_mask != 0


@pytest.mark.parametrize("quant_mode", ["mid", "deadzone"])
def test_device_sweep_matches_jax_host(rng, quant_mode):
    depth = 7
    jf, tf = _smooth_frame(rng, n=1500, depth=depth)
    host = jp.AttributeCodec(depth, predict=True, predict_impl="host", quant_mode=quant_mode)
    dev = tp.AttributeCodec(depth, predict=True, predict_impl="device", device="cpu",
                            quant_mode=quant_mode)
    steps = [1.0, 2.0, 8.0, 32.0]
    sweep = dev.encode_sweep(tf, steps)
    for s, ed in zip(steps, sweep):
        eh = tp.FrameStream.from_bytes(host.encode(jf, s).stream.to_bytes())
        _tie_gate(jnp.float64, tf, eh, ed.stream, quant_mode)
        assert ed.stream.to_bytes() == dev.encode(tf, s).stream.to_bytes()
        assert set(ed.timer.stages) == {"Quant_time", "Entropy_enc_time"}


def test_device_f32_stream_and_decode(rng):
    depth = 7
    jf, tf = _smooth_frame(rng, n=1500, depth=depth, dtype=jnp.float32)
    host = jp.AttributeCodec(depth, dtype=jnp.float32, predict=True, predict_impl="host")
    dev = tp.AttributeCodec(depth, dtype=torch.float32, predict=True,
                            predict_impl="device", device="cpu")
    eh = tp.FrameStream.from_bytes(host.encode(jf, 2.0).stream.to_bytes())
    ed = dev.encode(tf, 2.0).stream
    assert ed.dtype32
    _tie_gate(jnp.float32, tf, eh, ed)
    _check_rec(jnp.float32, dev, tf, ed, 2.0)
    rec, _ = dev.decode(ed, tf.codes, tf.weights)
    assert rec.dtype == np.float32
    assert np.abs(rec - tf.attributes.numpy()[:tf.n_voxels]).max() <= 2 * 2.0


def test_device_cache_across_frames(rng):
    """The identity-keyed device cache never serves a stale plan to another
    frame (entries pin their frame)."""
    depth = 7
    f1 = _smooth_frame(rng, n=1200, depth=depth)
    f2 = _smooth_frame(rng, n=900, depth=depth)
    host = jp.AttributeCodec(depth, predict=True, predict_impl="host")
    dev = tp.AttributeCodec(depth, predict=True, predict_impl="device", device="cpu")
    for jf, tf in (f1, f2, f1):
        eh = tp.FrameStream.from_bytes(host.encode(jf, 4.0).stream.to_bytes())
        _tie_gate(jnp.float64, tf, eh, dev.encode(tf, 4.0).stream)
    assert len(dev._praht_dev_cache) == 2


@pytest.mark.parametrize("jdt", [jnp.float64, jnp.float32])
def test_device_decode_matches_host_decode(rng, jdt):
    """The non-normative device decode reproduces the frozen host loop."""
    depth = 8
    jf, tf = _smooth_frame(rng, dtype=jdt)
    codec = tp.AttributeCodec(depth, dtype=_TORCH[jdt], predict=True, predict_impl="host",
                              device="cpu")
    stream = codec.encode(tf, 2.0).stream
    rec_host, _ = codec.decode(stream, tf.codes, tf.weights)
    vals_T = np.zeros((stream.n_channels, tf.codes.shape[0]), np.int32)
    tp.decode_entropy_channels(stream, stream.n_voxels, vals_T)
    inv = tp._inverse_order_device(tf.codes, tf.weights, stream.n_voxels, depth, "ragft")
    plan = codec._praht_dev_context(tf)[2]
    sym = torch.from_numpy(vals_T).T[inv.long()]
    rec_dev = tpd.praht_device_decode(
        plan, tf.codes, tf.weights, sym, stream.predict_mask, depth,
        torch.tensor([2.0]), quant_mode=stream.quant_mode, rec_delta=stream.rec_delta,
        fdtype=_TORCH[jdt])[:tf.n_voxels].numpy()
    scale = np.ptp(tf.attributes.numpy()[:tf.n_voxels], axis=0)
    assert (np.abs(rec_dev - rec_host) <= _REC_TOL[jdt] * scale).all()


def test_adaptive_off_matches_jax_host(rng):
    depth = 6
    jf, tf = _smooth_frame(rng, n=1000, depth=depth)
    n = tf.n_voxels
    codec = tp.AttributeCodec(depth, predict=True, predict_impl="device", device="cpu")
    coeffs, order, plan = codec._praht_dev_context(tf)
    sym, mask, rec = tpd.praht_device_encode(plan, tf.codes, tf.weights, coeffs, depth,
                                             torch.tensor([2.0], dtype=torch.float64),
                                             adaptive=False)
    want = jpr.praht_encode(tf.codes.numpy()[:n], tf.attributes.numpy()[:n],
                            tf.weights.numpy()[:n], depth, 2.0, adaptive=False)
    got = tp._reorder_T_device(sym, order, n)[:, :n].numpy()
    assert int(mask) == want[1] == (1 << depth) - 1
    assert np.array_equal(got, want[0])
    assert np.abs(rec[:n].numpy() - want[2]).max() <= 1e-9 * np.ptp(want[2])


def test_codelen_bits_matches_host_proxy_at_int32_edges():
    edges = [0, 1, -1, 2, 3, 4, 7, 8, (1 << 24) - 1, 1 << 24, (1 << 24) + 1,
             -((1 << 24) + 1), (1 << 30) - 1, 1 << 30, (1 << 31) - 1, -(1 << 31) + 1,
             -(1 << 31)]
    edges += [s * ((1 << k) + e) for k in range(2, 31) for e in (-1, 0, 1) for s in (1, -1)]
    q = np.array(edges, dtype=np.int32)
    got = tpd._codelen_bits(torch.from_numpy(q)).numpy()
    assert got.dtype == np.int64
    want = [jpr._codelen_proxy(np.array([v], np.int32)) for v in q]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jpd._codelen_bits(jnp.asarray(q))))
    assert float(got.sum()) == tpr._codelen_proxy(q)


def _far_face_frame(rng, depth):
    """Voxels on both far faces of every axis (coordinates 0 and 2^J - 1)
    beside random ones, in both packages."""
    hi = (1 << depth) - 1
    corners = np.array([[x, y, z] for x in (0, hi) for y in (0, hi) for z in (0, hi)])
    faces = []
    for ax in range(3):
        for v in (0, 1, hi - 1, hi):
            p = rng.integers(0, hi + 1, (40, 3))
            p[:, ax] = v
            faces.append(p)
    pts = np.concatenate([corners, *faces, rng.integers(0, hi + 1, (600, 3))])
    pts = np.unique(pts, axis=0)
    attrs = rng.normal(size=(len(pts), 2))
    jf = jp.prepare_voxel_frame(pts, attrs, depth, bucket=256)
    tf = tp.voxel_frame_from_arrays(np.array(jf.codes), np.array(jf.attributes),
                                    np.array(jf.weights), jf.n_voxels, depth, jf.vmin,
                                    jf.width, device="cpu")
    return jf, tf


@pytest.mark.parametrize("depth,code_dtype", [(10, torch.int32), (12, torch.int64)])
def test_stencil_matches_jax_plan_on_far_faces(rng, depth, code_dtype):
    jf, tf = _far_face_frame(rng, depth)
    assert tf.codes.dtype == code_dtype
    _, _, js = jp._transform_device(jf.codes, jp._scale_sqrt_w(jf.attributes, jf.weights),
                                    jf.weights, depth, "ragft", "span")
    jplan = jpd.praht_device_plan(jf.codes, jf.weights, depth, js.drop_level, js.subtree_w)
    _, _, ts = tp._transform_device(tf.codes, tp._scale_sqrt_w(tf.attributes, tf.weights),
                                    tf.weights, depth)
    assert np.array_equal(ts.drop_level.numpy(), np.asarray(js.drop_level))
    plan = tpd.praht_device_plan(tf.codes, tf.weights, depth, ts.drop_level, ts.subtree_w)
    assert np.array_equal(plan.w_stack.numpy(), np.asarray(jplan.w_stack))
    wt = plan.st_wt.numpy()
    assert np.array_equal(wt, np.asarray(jplan.st_wt))
    hit = wt > 0
    assert np.array_equal(plan.st_idx.numpy()[hit], np.asarray(jplan.st_idx)[hit])
    # every face and edge lane is hit at some depth
    assert hit.any(axis=(0, 1)).all()


def test_depth_guard_and_auto_on_cpu():
    with pytest.raises(ValueError, match="device"):
        tp.AttributeCodec(21, predict=True, predict_impl="device", device="cpu")
    z = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="depth <= 20"):
        tpd.praht_device_plan(z, torch.ones(4), 21, z.int(), torch.ones(4))
    codec = tp.AttributeCodec(8, predict=True, device="cpu")
    assert codec.predict_impl == "auto" and codec._predict_on_device() is False
    assert tp.AttributeCodec(8, predict=True, predict_impl="device",
                             device="cpu")._predict_on_device() is True


@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
def test_active_neighbors_match_jax(rng, density):
    """succ / pred of the active positions (a cumsum-and-scatter form of
    the JAX package's cummin / cummax), at the edges: none or all active."""
    from raht3dgs_tpu.ops import raht as jraht
    from raht3dgs_tpu_torch.ops import raht as traht

    for n in (1, 2, 7, 3000):
        active = rng.random(n) < density
        a = torch.from_numpy(active)
        np.testing.assert_array_equal(traht._succ_active(a).numpy(),
                                      np.asarray(jraht._succ_active(jnp.asarray(active))))
        np.testing.assert_array_equal(traht._pred_active(a).numpy(),
                                      np.asarray(jraht._pred_active(jnp.asarray(active))))
