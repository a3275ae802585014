"""The native pack of the upload tiers (``native/upload_pack.cpp`` behind
``models/pipeline.py:pack_quantized_upload``) against the numpy pack it
replaces and the JAX package's, array for array in dtype, shape and value,
on every pool size; and the inputs that keep the numpy pack."""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from raht3dgs_tpu.models import pipeline as jp
from raht3dgs_tpu_torch.models import pipeline as tp
from raht3dgs_tpu_torch.utils import timing
from test_torch_serving import SWITCHES, UPLOAD_CASES

BLOCK = 1 << 16
I32_MIN, I32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max
THREADS = [1, 2, 7, 0]


def _same(got, want):
    """One QuantizedUpload, array for array in dtype, shape and value."""
    assert got.shape == want.shape
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b)


def _with(vals, idx, new):
    vals = np.asarray(vals).astype(np.int32)
    vals.reshape(-1)[np.asarray(idx)] = new
    return vals


def _sparse(rng, shape, share, hi):
    """``share`` of the entries nonzero, drawn in ``[-hi, hi]`` but zero."""
    vals = np.zeros(shape, dtype=np.int32)
    flat = vals.reshape(-1)
    pos = rng.choice(flat.size, size=max(1, int(flat.size * share)), replace=False)
    flat[pos] = rng.choice([-1, 1], pos.size) * rng.integers(1, hi + 1, pos.size)
    return vals


def _patched(rng, n, lo, share, big):
    """Entries in ``(-lo, lo)`` with ``share`` of them replaced by ``big``
    values of either sign: a dense tier with a patch across blocks."""
    vals = rng.integers(-lo + 1, lo, n).astype(np.int32)
    pos = rng.choice(n, size=max(1, int(n * share)), replace=False)
    vals[pos] = rng.choice([-1, 1], pos.size) * rng.integers(lo, big, pos.size)
    return vals


EDGE_CASES = {
    "one_entry": lambda rng: np.array([-7], np.int32),
    "one_entry_min": lambda rng: np.array([[I32_MIN]], np.int32),
    "one_entry_zero": lambda rng: np.zeros((1, 1), np.int32),
    "int32_extremes_sparse": lambda rng: _with(np.zeros((4, 1000)), [0, 17, 999, 2500, 3999],
                                               [I32_MIN, I32_MAX, -128, 32_768, -32_768]),
    "int32_extremes_int8_patch": lambda rng: _with(rng.integers(-100, 100, (8, 5000)),
                                                   [3, 4, 39_999], [I32_MIN, I32_MAX, I32_MIN]),
    "int32_extremes_int16_patch": lambda rng: _with(
        rng.integers(-3000, 3000, (3, 7000)), [1, 2, 20_999], [I32_MAX, I32_MIN, -I32_MAX]),
    "int32_dense_extremes": lambda rng: rng.choice(
        np.array([I32_MIN, I32_MAX, 0, -1, 40_000], np.int32), (5, 900)),
    "single_nonzero": lambda rng: _with(np.zeros((56, 4096)), [56 * 4096 // 2 + 3], [3]),
    "single_nonzero_last": lambda rng: _with(np.zeros(3 * BLOCK + 5), [3 * BLOCK + 4], [-200]),
    "dense_block_minus_1": lambda rng: _patched(rng, BLOCK - 1, 128, 0.02, 1000),
    "dense_block": lambda rng: _patched(rng, BLOCK, 128, 0.02, 1000),
    "dense_block_plus_1": lambda rng: _patched(rng, BLOCK + 1, 128, 0.02, 1000),
    "sparse_block_minus_1": lambda rng: _sparse(rng, (BLOCK - 1,), 0.05, 100),
    "sparse_block_plus_1": lambda rng: _sparse(rng, (BLOCK + 1,), 0.05, 100),
    "int8_patch_blocks": lambda rng: _patched(rng, 5 * BLOCK + 77, 128, 0.05, 30_000)
    .reshape(1, -1),
    "int16_patch_blocks": lambda rng: _patched(rng, 3 * BLOCK + 3, 1 << 15, 0.05, 1 << 24)
    .reshape(3, -1),
    "int32_blocks": lambda rng: _patched(rng, 2 * BLOCK + 3, 1 << 15, 0.2, 1 << 20),
    "int16_blocks": lambda rng: rng.integers(-32_767, 32_768, 2 * BLOCK + 9).astype(np.int32),
    "gs_9pct_int8": lambda rng: _sparse(rng, (56, 8192 * 3), 0.09, 127),
    "gs_9pct_int16": lambda rng: _sparse(rng, (56, 8192 * 3), 0.09, 2000),
    "gs_9pct_int32": lambda rng: _with(_sparse(rng, (56, 8192 * 3), 0.09, 100), [77], [I32_MIN]),
    "gs_9pct_batched": lambda rng: _sparse(rng, (2, 56, 8192), 0.09, 300),
}


@pytest.mark.parametrize("switches", list(SWITCHES))
@pytest.mark.parametrize("case", list(UPLOAD_CASES))
def test_upload_cases_match_numpy_and_jax(monkeypatch, case, switches):
    """Every case of the serving tests under every switch: the native pass
    gives the numpy pack's arrays and the JAX package's."""
    for k, v in SWITCHES[switches].items():
        monkeypatch.setenv(k, v)
    vals = UPLOAD_CASES[case](np.random.default_rng(7))
    want = jp.pack_quantized_upload(vals)
    _same(tp.pack_quantized_upload(vals), want)
    if vals.dtype != np.int32:
        with pytest.raises(ValueError):
            tp.pack_upload_native(vals)
        return
    _same(tp._numpy_pack_upload(vals), want)
    for t in THREADS:
        _same(tp.pack_upload_native(vals, threads=t), want)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_edge_cases_match_numpy_and_jax(case, threads):
    """Extremes, single nonzeros, sizes about a block, and 56-channel
    matrices at ~9% nonzeros: the numpy pack's arrays and the JAX package's
    on every pool size, and the same bytes as one thread."""
    vals = EDGE_CASES[case](np.random.default_rng(11))
    assert vals.dtype == np.int32 and vals.flags.c_contiguous
    got = tp.pack_upload_native(vals, threads=threads)
    want = jp.pack_quantized_upload(vals)
    _same(got, want)
    _same(tp._numpy_pack_upload(vals), want)
    one = tp.pack_upload_native(vals, threads=1)
    for a, b in zip(got[:3], one[:3]):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("switches", list(SWITCHES))
@pytest.mark.parametrize("case", ["gs_9pct_int16", "int8_patch_blocks", "int16_patch_blocks",
                                  "int32_extremes_sparse"])
def test_switches_on_blocks(monkeypatch, case, switches):
    """``RAHT3DGS_UPLOAD_PATCH`` and ``RAHT3DGS_UPLOAD_SPARSE`` pick the same
    tier on the native pass as on the numpy pack, over many blocks."""
    for k, v in SWITCHES[switches].items():
        monkeypatch.setenv(k, v)
    vals = EDGE_CASES[case](np.random.default_rng(5))
    want = jp.pack_quantized_upload(vals)
    _same(tp._numpy_pack_upload(vals), want)
    for t in THREADS:
        _same(tp.pack_upload_native(vals, threads=t), want)


def test_tiers_of_the_edge_cases():
    """The tiers the edge cases reach (a guard on the fixtures): every
    dense tier with and without a patch, and sparse values of each width."""
    rng = np.random.default_rng(11)
    picks = {}
    for case, make in EDGE_CASES.items():
        up = tp.pack_upload_native(make(rng))
        picks[case] = ("sparse" if up.shape is not None else "dense", up.vals.dtype.name,
                       up.patch_idx.size > 0)
    assert picks["int8_patch_blocks"] == ("dense", "int8", True)
    assert picks["int16_patch_blocks"] == ("dense", "int16", True)
    assert picks["int16_blocks"] == ("dense", "int16", False)
    assert picks["int32_blocks"] == ("dense", "int32", False)
    assert picks["dense_block_plus_1"] == ("dense", "int8", True)
    assert picks["int32_extremes_int8_patch"] == ("dense", "int8", True)
    assert picks["int32_extremes_int16_patch"] == ("dense", "int16", True)
    assert [picks[f"gs_9pct_int{b}"][:2] for b in (8, 16, 32)] == \
        [("sparse", "int8"), ("sparse", "int16"), ("sparse", "int32")]
    assert picks["one_entry_zero"] == ("dense", "int8", False)


def test_block_matches_the_library():
    assert tp.UPLOAD_PACK.load().upload_pack_block() == BLOCK


def _numpy_inputs():
    rng = np.random.default_rng(3)
    base = _with(rng.integers(-100, 100, (56, 300)), [5, 900], [40_000, I32_MIN])
    sparse = _sparse(rng, (56, 400), 0.05, 100)
    return {
        "transposed": base.T,
        "transposed_sparse": sparse.T,
        "strided_columns": base[:, ::2],
        "empty": np.zeros((0,), np.int32),
        "empty_rows": np.zeros((0, 5), np.int32),
        "empty_columns": np.zeros((56, 0), np.int32),
    }


@pytest.mark.parametrize("case", sorted(_numpy_inputs()))
def test_other_int32_inputs_keep_numpy(case, monkeypatch):
    """A strided view and an empty array take the numpy pack, with the JAX
    package's arrays, and the native pass refuses them."""
    vals = _numpy_inputs()[case]
    with pytest.raises(ValueError):
        tp.pack_upload_native(vals)

    def refuse(*a, **k):
        raise AssertionError("the native pass ran")

    monkeypatch.setattr(tp, "pack_upload_native", refuse)
    _same(tp.pack_quantized_upload(vals), jp.pack_quantized_upload(vals))


@pytest.mark.parametrize("dtype", [np.int16, np.int64, np.float32])
def test_other_dtypes_return_as_they_are(dtype, monkeypatch):
    monkeypatch.setattr(tp, "pack_upload_native", None)
    vals = np.arange(-50, 50).reshape(4, 25).astype(dtype)
    up = tp.pack_quantized_upload(vals)
    assert up.vals is vals and up.patch_idx.size == 0 and up.shape is None
    _same(up, jp.pack_quantized_upload(vals))


def test_counter_counts_the_native_calls():
    """``upload_pack_native`` counts exactly the calls that took the
    native pass, and only while a profiler records."""
    inputs = _numpy_inputs()
    native = [UPLOAD_CASES["int8_patch"](np.random.default_rng(7)),
              EDGE_CASES["gs_9pct_batched"](np.random.default_rng(7)),
              np.array([I32_MIN], np.int32)]
    others = [inputs["transposed"], inputs["empty"], native[0].astype(np.int16)]
    timing.reset()
    try:
        for v in native + others:
            tp.pack_quantized_upload(v)
        assert timing.COUNTS == {}
        with profile(activities=[ProfilerActivity.CPU]):
            for v in native + others + native[:1]:
                tp.pack_quantized_upload(v)
        assert timing.snapshot()["counts"].get("upload_pack_native") == len(native) + 1
    finally:
        timing.reset()
