"""The port's predicted-RAHT host spec (``ops/praht.py``, its native twin
``native/praht.cpp`` and the codec's predicted path) against the JAX
package's.

The host closed loop is the frozen decode spec, numpy only, so the gate is
bitwise: the same numpy inputs give the same symbols, mask and
reconstruction through the native library, the numpy twin
(``backend="python"``) and the JAX package, and a host-encoded stream is
byte-identical across packages. Small sizes: n <= 3000, depth <= 8.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raht3dgs_tpu.codec.bitstream import FrameStream as JaxStream
from raht3dgs_tpu.models import pipeline as jp
from raht3dgs_tpu.ops import praht as jpr
from raht3dgs_tpu.ops.prelude import morton_codes_np
from raht3dgs_tpu_torch.codec import _native
from raht3dgs_tpu_torch.codec.bitstream import FrameStream
from raht3dgs_tpu_torch.models import pipeline as tp
from raht3dgs_tpu_torch.ops import _praht_native, praht as tpr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TORCH = {jnp.float64: torch.float64, jnp.float32: torch.float32}


def _codes(rng, n, depth):
    pts = rng.integers(0, 2**depth, (3 * n, 3))
    return np.unique(morton_codes_np(pts, depth))[:n]


def _attrs(codes, depth, rng, content, d=3):
    """Smooth (prediction wins at some depths) or noise (it should not)."""
    if content == "noise":
        return rng.normal(0, 40, (len(codes), d))
    V = jpr._decode_axes_np(codes.astype(np.uint64), depth).astype(float)
    return V @ rng.uniform(0.5, 2.0, (3, d)) + rng.normal(0, 1.0, (len(codes), d))


def _same(a, b):
    """Bitwise equality of two encoder outputs ``(sym, mask, rec)``."""
    return (np.array_equal(a[0], b[0]) and a[1] == b[1]
            and a[2].dtype == b[2].dtype and np.array_equal(a[2], b[2]))


@pytest.mark.parametrize("content", ["smooth", "noise"])
@pytest.mark.parametrize("quant_mode", ["mid", "deadzone"])
@pytest.mark.parametrize("fdtype", [np.float64, np.float32])
def test_encode_decode_bitwise_equal_jax(rng, fdtype, quant_mode, content):
    depth = 6
    codes = _codes(rng, 1500, depth)
    attrs = _attrs(codes, depth, rng, content)
    w = rng.integers(1, 4, len(codes)).astype(float)  # multiplicity weights
    steps = np.array([1.0, 2.5, 4.0])                # per-channel steps
    kw = dict(quant_mode=quant_mode, fdtype=fdtype)
    want = jpr.praht_encode(codes, attrs, w, depth, steps, **kw)
    dec = jpr.praht_decode(want[0], codes, w, depth, steps, predict_mask=want[1], **kw)
    assert np.array_equal(dec, want[2])
    if content == "smooth":
        assert want[1] != 0
    for backend in tpr.BACKENDS:
        got = tpr.praht_encode(codes, attrs, w, depth, steps, backend=backend, **kw)
        assert _same(got, want), backend
        out = tpr.praht_decode(got[0], codes, w, depth, steps, predict_mask=got[1],
                               backend=backend, **kw)
        assert np.array_equal(out, dec) and out.dtype == dec.dtype
    # prediction forced on at every depth, scalar step
    want = jpr.praht_encode(codes, attrs, w, depth, 2.0, adaptive=False, **kw)
    for backend in tpr.BACKENDS:
        got = tpr.praht_encode(codes, attrs, w, depth, 2.0, adaptive=False,
                               backend=backend, **kw)
        assert _same(got, want) and got[1] == (1 << depth) - 1


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_shallow_depths_and_lod_decode_bitwise_equal_jax(rng, depth):
    codes = _codes(rng, min(200, 8**depth // 2), depth)
    attrs = _attrs(codes, depth, rng, "smooth")
    w = np.ones(len(codes))
    want = jpr.praht_encode(codes, attrs, w, depth, 0.5)
    for backend in tpr.BACKENDS:
        assert _same(tpr.praht_encode(codes, attrs, w, depth, 0.5, backend=backend), want)
        for lod in range(depth + 1):
            a = jpr.praht_decode(want[0], codes, w, depth, 0.5, predict_mask=want[1],
                                 lod_depth=lod)
            b = tpr.praht_decode(want[0], codes, w, depth, 0.5, predict_mask=want[1],
                                 lod_depth=lod, backend=backend)
            for x, y in zip(a, b):
                assert np.array_equal(x, y)


def test_plan_parts_and_guards_match_jax(rng):
    depth = 5
    codes = _codes(rng, 900, depth)
    attrs = _attrs(codes, depth, rng, "smooth")
    w = rng.integers(1, 3, len(codes)).astype(float)
    jplan = jpr.praht_plan(codes, w, depth)
    for backend in tpr.BACKENDS:
        plan = tpr.praht_plan(codes, w, depth, backend=backend)
        for lj, lt in zip(jplan.levels, plan.levels):
            for f in ("base_j", "idx_surv", "is_ac", "sq", "sqrt_pw", "ac_rows"):
                assert np.array_equal(getattr(lj, f), getattr(lt, f)), f
            for a, b in zip(lj.csr + lj.flat, lt.csr + lt.flat):
                assert np.array_equal(a, b)
            for (r0, k0, w0), (r1, k1, w1) in zip(lj.cands, lt.cands):
                assert np.array_equal(r0, r1) and np.array_equal(k0, k1) and w0 == w1
        dc_j, tt_j = jpr.praht_true_coeffs(jplan, attrs)
        dc_t, tt_t = tpr.praht_true_coeffs(plan, attrs, backend)
        assert np.array_equal(dc_j, dc_t)
        assert all(np.array_equal(a, b) for a, b in zip(tt_j, tt_t))
    # a plan of another frame, dtype or weights is refused, as in JAX
    other = tpr.praht_plan(_codes(rng, 900, depth), np.ones(900), depth)
    for plan, match in ((other, "Morton codes"),
                        (tpr.praht_plan(codes, w, depth, np.float32), "float32"),
                        (tpr.praht_plan(codes, w * 2, depth), "weights")):
        with pytest.raises(ValueError, match=match):
            tpr.praht_encode(codes, attrs, w, depth, 2.0, plan=plan)
    with pytest.raises(ValueError, match="backend"):
        tpr.praht_encode(codes, attrs, w, depth, 2.0, backend="cuda")
    pm = np.random.default_rng(1).normal(size=(len(jplan.pyramid[2][0]), 3))
    np.testing.assert_array_equal(
        tpr.predict_means(jplan.pyramid[2][0], pm, jplan.pyramid[3][0], 3),
        jpr.predict_means(jplan.pyramid[2][0], pm, jplan.pyramid[3][0], 3))


def test_native_source_byte_identical_to_jax_copy():
    assert filecmp.cmp(os.path.join(REPO, "raht3dgs_tpu_torch", "native", "praht.cpp"),
                       os.path.join(REPO, "raht3dgs_tpu", "native", "praht.cpp"),
                       shallow=False)
    lib = _praht_native.NATIVE
    assert os.path.dirname(lib.lib_path) == _native.BUILD_DIR
    assert "-ffp-contract=off" in lib._command(lib.src, "x.so")


def test_failed_build_raises(tmp_path, monkeypatch, rng):
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path))
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(_praht_native, "NATIVE", _native.NativeLib(
        str(src), "libbroken.so", _praht_native._configure, _native.gxx_command))
    codes = _codes(rng, 100, 3)
    with pytest.raises(RuntimeError, match="failed"):
        tpr.praht_encode(codes, np.ones((100, 1)), np.ones(100), 3, 1.0)
    # the numpy twin needs no library
    tpr.praht_encode(codes, np.ones((100, 1)), np.ones(100), 3, 1.0, backend="python")


def _frames(rng, jdt, n=1500, depth=7, weights=False):
    pts = jpr._decode_axes_np(_codes(rng, n, depth).astype(np.uint64), depth)
    attrs = (pts[:, :1] * 0.4 + pts[:, 1:2] * 0.2 + rng.normal(0, 1, (len(pts), 3))) * 10
    w = rng.integers(1, 4, len(pts)).astype(float) if weights else None
    jf = jp.prepare_voxel_frame(pts, attrs, depth, bucket=512, dtype=jdt, weights=w)
    tf = tp.voxel_frame_from_arrays(np.array(jf.codes), np.array(jf.attributes),
                                    np.array(jf.weights), jf.n_voxels, depth, jf.vmin,
                                    jf.width, device="cpu")
    return jf, tf, depth


@pytest.mark.parametrize("quant_mode,entropy,weights", [
    ("mid", "rlgr", False), ("deadzone", "rlgr", True), ("mid", "auto", False)])
@pytest.mark.parametrize("jdt", [jnp.float64, jnp.float32])
def test_codec_host_streams_byte_identical_to_jax(rng, jdt, quant_mode, entropy, weights):
    jf, tf, depth = _frames(rng, jdt, weights=weights)
    kw = dict(predict=True, predict_impl="host", quant_mode=quant_mode, entropy=entropy)
    jc = jp.AttributeCodec(depth, dtype=jdt, **kw)
    tc = tp.AttributeCodec(depth, dtype=_TORCH[jdt], device="cpu", **kw)
    steps = [1.0, 4.0, [2.0, 4.0, 8.0]]
    want = [jc.encode(jf, s).stream.to_bytes() for s in steps]
    got = [e.stream.to_bytes() for e in tc.encode_sweep(tf, steps)]
    assert got == want
    assert [tc.encode(tf, s).stream.to_bytes() for s in steps] == want
    st = FrameStream.from_bytes(got[0])
    assert st.predict and st.predict_mask != 0 and st.dtype32 == (jdt == jnp.float32)
    # streams decode across both packages, both ways, bitwise equal
    for blob in (want[1], got[2]):
        a, _ = jc.decode(JaxStream.from_bytes(blob), jf.codes, jf.weights)
        b, _ = tc.decode(FrameStream.from_bytes(blob), tf.codes, tf.weights)
        assert np.array_equal(np.asarray(a), b) and b.shape == (tf.n_voxels, 3)


def test_prefix_decode_is_the_same_prediction_cascade(rng):
    jf, tf, depth = _frames(rng, jnp.float64)
    blob = tp.AttributeCodec(depth, predict=True, device="cpu").encode(tf, 2.0) \
        .stream.to_bytes()
    jc = jp.AttributeCodec(depth)   # a plain codec decodes a predicted stream
    tc = tp.AttributeCodec(depth, device="cpu")
    full, _ = tc.decode(FrameStream.from_bytes(blob), tf.codes, tf.weights)
    for k in (1, 40, tf.n_voxels // 2, tf.n_voxels):
        a, _ = jc.decode_progressive(JaxStream.from_bytes(blob), jf.codes, jf.weights, k)
        b, _ = tc.decode_progressive(FrameStream.from_bytes(blob), tf.codes, tf.weights, k)
        assert np.array_equal(np.asarray(a), b) and np.isfinite(b).all()
    assert np.array_equal(b, full)


def test_corrupt_mask_and_order_fail_as_in_jax(rng):
    jf, tf, depth = _frames(rng, jnp.float64, n=800, depth=6)
    st = tp.AttributeCodec(depth, predict=True, device="cpu").encode(tf, 2.0).stream
    blob = st.to_bytes()
    # a cut predict mask: both containers refuse it
    kw = dict(depth=6, n_voxels=10, steps=np.asarray([2.0]), channels=[b"ab", b"c"],
              predict=True, predict_mask=0b101101)
    head = FrameStream(**kw).to_bytes()
    assert head == JaxStream(**kw).to_bytes()
    off = len(b"R3TC") + 1 + 1 + 1 + 2 + 8 + 2  # the flags2 byte
    for cls in (FrameStream, JaxStream):
        assert cls.from_bytes(head).predict_mask == 0b101101
        with pytest.raises(ValueError, match="predict mask"):
            cls.from_bytes(head[:off + 1])
    # a flipped mask bit decodes deterministically, the same in both packages
    st.predict_mask ^= 1 << (st.predict_mask.bit_length() - 1)
    flipped = st.to_bytes()
    a, _ = jp.AttributeCodec(depth).decode(JaxStream.from_bytes(flipped), jf.codes,
                                          jf.weights)
    b, _ = tp.AttributeCodec(depth, device="cpu").decode(
        FrameStream.from_bytes(flipped), tf.codes, tf.weights)
    good, _ = tp.AttributeCodec(depth, device="cpu").decode(
        FrameStream.from_bytes(blob), tf.codes, tf.weights)
    assert np.array_equal(np.asarray(a), b) and not np.array_equal(b, good)
    # a predicted stream in another coefficient order
    st.order_mode = "morton"
    for codec, frame, cls in ((jp.AttributeCodec(depth), jf, JaxStream),
                              (tp.AttributeCodec(depth, device="cpu"), tf, FrameStream)):
        with pytest.raises(ValueError, match="RA-GFT"):
            codec.decode(cls.from_bytes(st.to_bytes()), frame.codes, frame.weights)


def test_codec_guards_match_jax():
    for kw in (dict(order_mode="weight_desc"), dict(predict_impl="gpu")):
        with pytest.raises(ValueError):
            jp.AttributeCodec(6, predict=True, **kw)
        with pytest.raises(ValueError):
            tp.AttributeCodec(6, predict=True, device="cpu", **kw)
    with pytest.raises(ValueError, match="depth <= 20"):
        tp.AttributeCodec(21, predict=True, predict_impl="device", device="cpu")
    # the plan cache is shared by a sweep's encodes and decodes
    codec = tp.AttributeCodec(5, predict=True, device="cpu")
    frame = tp.prepare_voxel_frame(np.array([[0, 0, 0], [1, 2, 3], [31, 31, 31]]),
                                   np.eye(3), 5, device="cpu")
    for s in (1.0, 2.0):
        rec, _ = codec.decode(codec.encode(frame, s).stream, frame.codes, frame.weights)
        assert rec.shape == (3, 3)
    assert len(codec._praht_plans) == 1 and len(codec._praht_tcs) == 1
