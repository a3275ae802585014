"""The port's rate control against the JAX package's, on the CPU: the rate
model (``ops/rate_model.py``), the per-frame and two-pass step searches
(``models/rd_search.py``), the leaky-bucket controller
(``models/rate_control.py``) and the synthetic generators
(``eval/synth.py``).

Both packages get the same numpy input. Rate estimates agree within rtol
1e-12 (the costs are integers until the run-mode terms; only the order of
the last float64 sums differs). The searches run at float64 on non-integer
colours, where both packages' streams are byte-identical (ROADMAP queue A,
item 6's gate), so the chosen step, the probe and true-encode counts and
the stream bytes must be equal."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import unique_voxel_cloud
from raht3dgs_tpu.eval import synth as jsynth
from raht3dgs_tpu.models import pipeline as jp, rate_control as jrc, rd_search as jrd
from raht3dgs_tpu.ops import rate_model as jrm
from raht3dgs_tpu_torch.eval import synth as tsynth
from raht3dgs_tpu_torch.models import pipeline as tp, rate_control as trc, rd_search as trd
from raht3dgs_tpu_torch.ops import rate_model as trm

_TORCH = {jnp.float64: torch.float64, jnp.float32: torch.float32}
RTOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    """The searches run many small ops: one intra-op thread is faster on the
    CPU and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(jf):
    return tp.voxel_frame_from_arrays(np.array(jf.codes), np.array(jf.attributes),
                                      np.array(jf.weights), jf.n_voxels, jf.depth, jf.vmin,
                                      jf.width, device="cpu")


def _frames(rng, n=2000, depth=6, d_attr=3, bucket=512, dtype=jnp.float64, smooth=True):
    """A voxel frame with smooth non-integer attributes, in both packages."""
    pts, _, _ = unique_voxel_cloud(rng, n, depth, d_attr=1)
    if smooth:
        base = np.stack([np.sin(pts[:, 0] / 6.0) * 90 + 120,
                         (pts[:, 1] * 2.5 + pts[:, 2]) % 200 + 0.37,
                         np.cos(pts[:, 2] / 9.0) * 70 + 100], axis=1)
        attrs = np.concatenate([base] * (-(-d_attr // 3)), axis=1)[:, :d_attr]
        attrs = attrs + rng.normal(scale=2.0, size=attrs.shape)
    else:
        attrs = rng.uniform(0, 255, size=(len(pts), d_attr))
    jf = jp.prepare_voxel_frame(pts.astype(np.int64), attrs, depth, bucket=bucket,
                                dtype=dtype)
    return jf, _both(jf)


# -- ops/rate_model.py --------------------------------------------------------


def _symbols(rng, n, d):
    q = np.round(rng.laplace(scale=6.0, size=(n, d))).astype(np.int32)
    q[: 2 * trm.BLOCK] = 0                               # all-zero blocks
    q[2 * trm.BLOCK + 5, 0] = np.iinfo(np.int32).max    # large magnitudes
    q[2 * trm.BLOCK + 9, 1 % d] = np.iinfo(np.int32).min
    q[3 * trm.BLOCK: 3 * trm.BLOCK + 40] = rng.integers(-(1 << 20), 1 << 20, (40, d))
    sparse = slice(4 * trm.BLOCK, 5 * trm.BLOCK)         # run mode: a few nonzeros
    q[sparse] = 0
    q[4 * trm.BLOCK + 17: 5 * trm.BLOCK: 61] = 3
    return q


@pytest.mark.parametrize("n,d", [(1000, 3), (2 * 1024 + 77, 5), (1280, 1)])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
def test_estimate_rlgr_bits_matches_jax(rng, n, d, masked):
    q = _symbols(rng, n, d)
    valid = (np.arange(n) < n - 123) if masked else None
    want = np.asarray(jrm.estimate_rlgr_bits(
        jnp.asarray(q), valid=None if valid is None else jnp.asarray(valid)))
    got = trm.estimate_rlgr_bits(torch.from_numpy(q),
                                 valid=None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.float64 and got.shape == (d,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    nv = int(valid.sum()) if masked else n
    want_bpp = float(jrm.estimate_bpp(jnp.asarray(q), nv,
                                      valid=None if valid is None else jnp.asarray(valid)))
    got_bpp = float(trm.estimate_bpp(torch.from_numpy(q), nv,
                                     valid=None if valid is None else torch.from_numpy(valid)))
    assert got_bpp == pytest.approx(want_bpp, rel=RTOL)


def test_all_zero_block_costs_eight_bits():
    q = torch.zeros(3 * trm.BLOCK, 2, dtype=torch.int32)
    np.testing.assert_array_equal(trm.estimate_rlgr_bits(q).numpy(), [24.0, 24.0])
    np.testing.assert_array_equal(
        np.asarray(jrm.estimate_rlgr_bits(jnp.zeros((3 * trm.BLOCK, 2), jnp.int32))),
        [24.0, 24.0])


@pytest.mark.parametrize("jdt", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "per_channel"])
def test_estimate_bpp_grid_matches_jax(rng, monkeypatch, jdt, vector):
    """The grid on the JAX transform's own coefficients, in one call and in
    chunks of steps and of channels (the same numbers)."""
    jf, _ = _frames(rng, n=1500, depth=6, d_attr=4, dtype=jdt)
    coeffs = np.array(jp.AttributeCodec(6, dtype=jdt).transform(jf)[0])
    grid = np.geomspace(0.25, 4096.0, 64)
    mult = np.array([0.5, 0.5, 1.0, 2.0])
    steps = np.stack([s * mult if vector else np.atleast_1d(s) for s in grid])
    valid = np.arange(coeffs.shape[0]) < jf.n_voxels
    want = np.asarray(jrd._estimate_bpp_grid(
        jnp.asarray(coeffs), jnp.asarray(steps, dtype=coeffs.dtype), jnp.asarray(valid),
        jf.n_voxels))
    tc = torch.from_numpy(coeffs)
    ts = torch.from_numpy(steps).to(tc.dtype)
    tv = torch.from_numpy(valid)
    got = trd._estimate_bpp_grid(tc, ts, tv, jf.n_voxels)
    assert got.shape == (64,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    # a chunk of 3 steps' symbols, and one narrower than a step (channels)
    for chunk in (3 * coeffs.size, coeffs.shape[0]):
        monkeypatch.setattr(trm, "CHUNK_ELEMS", chunk)
        np.testing.assert_allclose(trm.estimate_bpp_grid(tc, ts, tv, jf.n_voxels).numpy(),
                                   want, rtol=RTOL, atol=0)
    assert (np.diff(want) <= 0).all()   # the model falls as the step grows


# -- models/rd_search.py ------------------------------------------------------


def _same_search(got, want):
    assert got.step == want.step
    assert got.bpp == want.bpp
    assert got.probes == want.probes
    assert got.true_encodes == want.true_encodes
    assert got.target_bpp == want.target_bpp
    assert got.encoded.stream.to_bytes() == want.encoded.stream.to_bytes()


_SEARCHES = {
    "default": ({}, None, 1.1),
    "deadzone": ({"quant_mode": "deadzone"}, None, 1.1),
    "vector_steps": ({}, np.array([0.5, 1.0, 2.0]), 1.1),
    "infeasible": ({}, None, 1e-4),
    "predict_host": ({"predict": True, "predict_impl": "host"}, None, 1.1),
}


@pytest.mark.parametrize("case", sorted(_SEARCHES))
def test_search_step_for_bpp_matches_jax(rng, case):
    kw, mult, scale = _SEARCHES[case]
    jf, tf = _frames(rng, n=2500, depth=6, bucket=1024)
    jc = jp.AttributeCodec(6, **kw)
    tc = tp.AttributeCodec(6, device="cpu", **kw)
    target = jp.AttributeCodec(6).encode(jf, 8.0).stream.bpp() * scale
    steps_fn = None if mult is None else (lambda s: s * mult)
    want = jrd.search_step_for_bpp(jf, target, codec=jc, steps_fn=steps_fn)
    got = trd.search_step_for_bpp(tf, target, codec=tc, steps_fn=steps_fn)
    _same_search(got, want)
    if case == "infeasible":
        assert got.step == 4096.0 and got.bpp > target
    else:
        assert target * 0.4 <= got.bpp <= target * 1.001
        # the chosen stream is the codec's own encode at the chosen step
        steps = got.step if mult is None else got.step * mult
        assert got.encoded.stream.to_bytes() == tc.encode(tf, steps).stream.to_bytes()
    assert got.encoded.stream.predict == bool(kw.get("predict"))


def test_search_default_codec_follows_the_frame(rng):
    jf, tf = _frames(rng, n=600, depth=5)
    got = trd.search_step_for_bpp(tf, 6.0)
    assert got.encoded.stream.n_voxels == tf.n_voxels
    _same_search(got, jrd.search_step_for_bpp(jf, 6.0))
    with pytest.raises(ValueError, match="positive"):
        trd.search_step_for_bpp(tf, 0.0)


def _sequence(rng, sizes, depth=6):
    pairs = [_frames(rng, n=n, depth=depth, bucket=2048) for n in sizes]
    return [j for j, _ in pairs], [t for _, t in pairs]


@pytest.mark.parametrize("target", [3.0, 0.05], ids=["feasible", "coarse"])
def test_search_global_step_matches_jax(rng, target):
    jfs, tfs = _sequence(rng, (1000, 1300, 1600))
    want = jrd.search_global_step_for_bpp(jfs, target, codec=jp.AttributeCodec(6))
    got = trd.search_global_step_for_bpp(tfs, target,
                                         codec=tp.AttributeCodec(6, device="cpu"))
    assert got.step == want.step and got.total_bpp == want.total_bpp
    assert got.probes == want.probes == 3 and got.target_bpp == want.target_bpp
    assert [e.stream.to_bytes() for e in got.encoded] == \
        [e.stream.to_bytes() for e in want.encoded]
    for enc in got.encoded:
        assert float(enc.stream.steps[0]) == got.step
    bits = sum(e.stream.payload_bytes * 8 for e in got.encoded)
    assert bits / sum(f.n_voxels for f in tfs) == got.total_bpp


def test_search_global_rejects_mixed_depth_and_empty(rng):
    _, t5 = _frames(rng, n=400, depth=5)
    _, t6 = _frames(rng, n=400, depth=6)
    with pytest.raises(ValueError, match="depth"):
        trd.search_global_step_for_bpp([t5, t6], 2.0)
    with pytest.raises(ValueError, match="no frames"):
        trd.search_global_step_for_bpp([], 2.0)
    with pytest.raises(ValueError, match="positive"):
        trd.search_global_step_for_bpp([t5], float("nan"))


# -- models/rate_control.py ---------------------------------------------------


@pytest.mark.parametrize("burst", [None, 0.0, 0.5, 2.0])
def test_rate_controller_matches_jax(burst):
    """The same credit, debt, budget and mean after the same updates,
    overspends (warned, carried as debt) and GOP resets included."""
    rng = np.random.default_rng(7)
    j, t = jrc.RateController(2.0, burst=burst), trc.RateController(2.0, burst=burst)
    for i in range(120):
        assert t.frame_budget() == j.frame_budget()
        if i % 25 == 24:
            j.reset_credit()
            t.reset_credit()
        spend = t.frame_budget() * rng.uniform(0.4, 1.0)
        if i in (10, 11, 60):
            spend = t.frame_budget() + rng.uniform(0.1, 5.0)
            with pytest.warns(RuntimeWarning, match="debt"):
                t.update(spend)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                j.update(spend)
        else:
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)
                t.update(spend)
                j.update(spend)
        assert (t.credit, t.frames, t.spent, t.mean_bpp, t.burst) == \
            (j.credit, j.frames, j.spent, j.mean_bpp, j.burst)
    for bad in ({"target_bpp": 0.0}, {"target_bpp": 1.0, "burst": -1.0}):
        with pytest.raises(ValueError):
            trc.RateController(**bad)
    assert trc.RateController(3.0).mean_bpp == 0.0


# -- eval/synth.py ------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("synthetic_color_frame", {"n": 3000, "depth": 8, "seed": 3}),
    ("synthetic_gs_frame", {"n": 1500, "depth": 7, "seed": 1}),
    ("synthetic_color_sequence", {"depth": 6, "seed": 2, "n_frames": 3, "samples": 4000}),
    ("synthetic_body_scan", {"depth": 6, "seed": 0, "n_frames": 2}),
], ids=lambda v: v if isinstance(v, str) else "")
def test_synth_generators_match_jax(name, kw):
    want, got = getattr(jsynth, name)(**kw), getattr(tsynth, name)(**kw)
    if not isinstance(want, list):
        want, got = [want], [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_synth_helpers_match_jax():
    for seed in range(3):
        a = jsynth._sample_capsule(np.random.default_rng(seed), (0, 0, 0.9), (0.1, 0, 1.4),
                                   0.16, 0.1, 500)
        b = tsynth._sample_capsule(np.random.default_rng(seed), (0, 0, 0.9), (0.1, 0, 1.4),
                                   0.16, 0.1, 500)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tsynth._rot_x(0.3), jsynth._rot_x(0.3))
    V = tsynth._unique_morton_voxels(np.random.default_rng(0), 200, 5)
    np.testing.assert_array_equal(V, jsynth._unique_morton_voxels(np.random.default_rng(0),
                                                                  200, 5))
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    np.testing.assert_array_equal(tsynth.smooth_field_fn(r1, V, 5)(3),
                                  jsynth.smooth_field_fn(r2, V, 5)(3))
