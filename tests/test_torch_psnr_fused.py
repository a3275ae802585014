"""The fused float32 pass of ``eval/metrics.py:gs_group_psnr``
(``native/sq_diff.cpp``): against a float64 reference, the same bits on
any pool size and run, and numpy's reductions unchanged on every input the
pass does not take. No test here needs JAX."""

import warnings

import numpy as np
import pytest

from raht3dgs_tpu_torch.eval import metrics
from raht3dgs_tpu_torch.eval.metrics import gs_group_psnr, sq_diff_col_sums
from raht3dgs_tpu_torch.ops.quantize import gs_attribute_groups


def _numpy_group_psnr(original, reconstructed, groups=None):
    """``gs_group_psnr`` as it was before the fused pass: the oracle of
    every input the pass leaves to numpy."""
    if groups is None:
        groups = gs_attribute_groups(original.shape[1])
    out = {}

    def psnr(a, b):
        mse = float(np.mean((a - b) ** 2))
        return -10.0 * np.log10(mse + 1e-10), mse

    p, m = psnr(original, reconstructed)
    out["psnr_all"] = p
    out["mse_all"] = m
    for name, (lo, hi) in groups.items():
        p, m = psnr(original[:, lo:hi], reconstructed[:, lo:hi])
        out[f"psnr_{name}"] = p
        out[f"mse_{name}"] = m
    return out


def _pair(n, d, seed=0):
    """A float32 original with columns of unlike scales and a
    reconstruction within a factor of 1.4 of it, sign for sign: each
    float32 difference is exact (Sterbenz), so the float64 reference and
    the fused pass differ only in how they sum."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.integers(-3, 3, size=d)
    a = (rng.choice([-1.0, 1.0], size=(n, d)) * rng.uniform(1, 2, (n, d)) * scale)
    a = a.astype(np.float32)
    b = (a * (1 + rng.uniform(-0.4, 0.4, (n, d)))).astype(np.float32)
    return a, b


def _same(x, y):
    """Equal dicts, value for value and type for type (NaN equal to NaN)."""
    assert list(x) == list(y)
    for k in x:
        assert type(x[k]) is type(y[k]), k
        assert x[k] == y[k] or (np.isnan(x[k]) and np.isnan(y[k])), (k, x[k], y[k])


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 100_003])
@pytest.mark.parametrize("d", [8, 20, 56, 59])
def test_fused_matches_float64_reference(n, d):
    a, b = _pair(n, d, seed=n + d)
    got = gs_group_psnr(a, b)
    want = gs_group_psnr(a.astype(np.float64), b.astype(np.float64))
    assert list(got) == list(want)
    for k in got:
        if k.startswith("mse_"):
            assert abs(got[k] - want[k]) <= 1e-9 * want[k], k
        else:
            assert abs(got[k] - want[k]) <= 1e-6, k


@pytest.mark.parametrize("n,d", [(1, 8), (4097, 20), (50_001, 56)])
def test_column_sums_are_the_float32_differences_summed_in_float64(n, d):
    """Any pair, signs flipping and differences rounding in float32: each
    column sum is the float64 sum of the squared float32 differences."""
    rng = np.random.default_rng(d)
    a = rng.normal(size=(n, d)).astype(np.float32)
    b = rng.normal(size=(n, d)).astype(np.float32)
    want = ((a - b).astype(np.float64) ** 2).sum(axis=0)
    np.testing.assert_allclose(sq_diff_col_sums(a, b), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("threads", [0, 2, 3, 8])
def test_same_bits_on_any_pool_and_run(threads):
    a, b = _pair(100_003, 56, seed=7)
    one = sq_diff_col_sums(a, b, threads=1)
    assert sq_diff_col_sums(a, b, threads=threads).tobytes() == one.tobytes()
    assert sq_diff_col_sums(a, b, threads=threads).tobytes() == one.tobytes()
    _same(gs_group_psnr(a, b), gs_group_psnr(a, b))


def _fallbacks():
    a, b = _pair(300, 20, seed=3)
    return {
        "float64": (a.astype(np.float64), b.astype(np.float64), None),
        "mixed_dtypes": (a, b.astype(np.float64), None),
        "float16": (a.astype(np.float16), b.astype(np.float16), None),
        "strided_rows": (a[::2], b[::2], None),
        "strided_columns": (a[:, ::2], b[:, ::2], None),
        "fortran_order": (np.asfortranarray(a), np.asfortranarray(b), None),
        "no_rows": (a[:0], b[:0], None),
        "empty_group": (a, b, {"quats": (0, 4), "none": (3, 3)}),
        "group_past_the_width": (a, b, {"quats": (0, 4), "past": (18, 24)}),
    }


@pytest.mark.parametrize("case", sorted(_fallbacks()))
def test_fallbacks_keep_numpy(case, monkeypatch):
    """Every input the fused pass does not take returns exactly what the
    numpy code returned, without the native pass."""
    def refuse(*a, **k):
        raise AssertionError("the fused pass ran")

    monkeypatch.setattr(metrics, "sq_diff_col_sums", refuse)
    a, b, groups = _fallbacks()[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # means of empty slices
        _same(gs_group_psnr(a, b, groups), _numpy_group_psnr(a, b, groups))


@pytest.mark.parametrize("d", [8, 20, 56, 59])
def test_equal_arrays_score_100_db(d):
    a, _ = _pair(5000, d, seed=d)
    out = gs_group_psnr(a, a.copy())
    for k, v in out.items():
        assert v == (0.0 if k.startswith("mse_") else 100.0), (k, v)


@pytest.mark.parametrize("bad", ["float64", "shapes", "no_rows", "strided"])
def test_column_sums_refuse_what_they_cannot_read(bad):
    a, b = _pair(10, 8)
    args = {"float64": (a.astype(np.float64), b.astype(np.float64)),
            "shapes": (a, b[:, :4].copy()), "no_rows": (a[:0], b[:0]),
            "strided": (a[:, ::2], b[:, ::2])}[bad]
    with pytest.raises(ValueError):
        sq_diff_col_sums(*args)
