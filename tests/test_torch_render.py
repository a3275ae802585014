"""The port's render comparison against the JAX package's: the point
renderer, the volumetric render with its capacity retry, render_comparison
and the rendering ablation, on the same numpy scenes, the JAX package on
the CPU and the port with ``device="cpu"``.

Tolerances: point renders within 1e-6 (XLA contracts ``0.5 + C0 * dc``
into a fused multiply-add) on scenes of distinct depths, where the z-buffer
has one winner a pixel; volumetric images within 5e-5 (the blend's
grouping); render_comparison's dict equal apart from its two timing
fields, PSNR within 1e-3 dB; the ablation's PSNR per group within 1e-2 dB.
"""

import warnings

import numpy as np
import pytest

from raht3dgs_tpu import config as jconf
from raht3dgs_tpu.eval import cameras as jcam, render as jrender
from raht3dgs_tpu.models import gs_quant_analysis as jqa
from raht3dgs_tpu_torch import config as tconf
from raht3dgs_tpu_torch.eval import rasterize as tr, render as trender
from raht3dgs_tpu_torch.models import gs_quant_analysis as tqa
from raht3dgs_tpu_torch.utils import device as tdev

from test_rasterize import _random_scene

_TIMES = ("original_render_time_ms", "merged_render_time_ms")


def _params(rng, n, sh_k=4, **kw):
    means, quats, scales, opac, colors = _random_scene(rng, n, sh_k=sh_k, **kw)
    return {"means": means, "quats": quats, "scales": scales, "opacities": opac,
            "colors": colors}


def _distinct_depth_scene(rng, n):
    p = _params(rng, n, sh_k=1)
    assert len(np.unique(p["means"][:, 2])) == n
    return p


@pytest.mark.parametrize("n,size,seed", [(400, 48, 1), (3000, 64, 2)])
def test_point_render_matches_jax(rng, n, size, seed):
    p = _distinct_depth_scene(rng, n)
    vms, Ks, W, H = jcam.generate_random_cameras(np.zeros(3), 2.5, 2, size, size, seed=seed)
    want = jrender.point_render(p, vms, Ks, W, H)
    got = trender.point_render(p, vms, Ks, W, H, device="cpu")
    assert got.shape == want.shape == (2, H, W, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got == 1.0, want == 1.0)  # the same pixels won
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got < 1.0).any()


@pytest.mark.parametrize("case", ["retry_recovers", "overflow_persists"])
def test_volumetric_render_retry_matches_jax(rng, case):
    """A clump of 1 500 splats in one tile overflows the 1 024 entries a
    tile; the retry at 4x recovers. With no retry left both packages warn
    with the same counts."""
    n = 1500
    p = {"means": rng.normal(0, 0.004, size=(n, 3)).astype(np.float32),
         "quats": np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
         "scales": np.full((n, 3), 0.002, np.float32),
         "opacities": np.full((n,), 0.05, np.float32),
         "colors": rng.normal(0, 0.2, size=(n, 3)).astype(np.float32)}
    vms, Ks, W, H = jcam.generate_random_cameras(np.zeros(3), 1.5, 1, 32, 32, seed=1)
    retries = 2 if case == "retry_recovers" else 0
    out = {}
    for name, mod, kw in (("j", jrender, {}), ("t", trender, {"device": "cpu"})):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out[name] = (mod.volumetric_render(p, vms, Ks, W, H, max_retries=retries, **kw),
                         [str(x.message) for x in w if "overflow" in str(x.message)])
    (a, wa), (b, wb) = out["j"], out["t"]
    assert wb == wa and len(wa) == (0 if retries else 1)
    assert b.shape == (1, H, W, 3)
    np.testing.assert_allclose(b, a, atol=5e-5)


def _compare_dicts(got, want):
    assert set(got) == set(want)
    for k in set(want) - set(_TIMES) - {"psnr_per_view", "psnr_avg", "psnr_std", "psnr_min",
                                          "psnr_max"}:
        assert got[k] == want[k], k
    for k in ("psnr_avg", "psnr_min", "psnr_max"):
        assert got[k] == want[k] or abs(got[k] - want[k]) <= 1e-3, k
    assert abs(got["psnr_std"] - want["psnr_std"]) <= 1e-3
    for x, y in zip(got["psnr_per_view"], want["psnr_per_view"], strict=True):
        assert x == y or abs(x - y) <= 1e-3
    for k in _TIMES:
        assert got[k] > 0


@pytest.mark.parametrize("backend", ["auto", "jax", "preview"])
def test_render_comparison_matches_jax(rng, tmp_path, backend):
    p = _params(rng, 120)
    q = dict(p, means=p["means"] + rng.normal(0, 0.03, p["means"].shape).astype(np.float32),
             colors=p["colors"] + rng.normal(0, 0.05, p["colors"].shape).astype(np.float32))
    kw = dict(n_views=2, image_size=48, seed=5)
    want = jrender.render_comparison(p, q, backend=backend, **kw)
    got = trender.render_comparison(p, q, backend=backend, device="cpu",
                                    output_dir=str(tmp_path / "views"), **kw)
    assert got["backend"] == ("preview" if backend == "preview" else "jax")
    assert all(np.isfinite(got["psnr_per_view"]))
    _compare_dicts(got, want)
    assert sorted(f.name for f in (tmp_path / "views").iterdir()) == [
        f"view_{i:03d}_{k}.png" for i in range(2) for k in ("comparison", "merged",
                                                            "original")]
    # a scene against itself: infinite PSNR in both
    same = trender.render_comparison(p, p, backend=backend, device="cpu", **kw)
    assert same["psnr_avg"] == float("inf") and same["psnr_std"] == 0.0


def test_render_comparison_none_gsplat_and_unknown(rng):
    p = _params(rng, 20)
    assert trender.render_comparison(p, p, backend="none") == {} == \
        jrender.render_comparison(p, p, backend="none")
    with pytest.warns(UserWarning, match="gsplat rendering unavailable"):
        assert trender.render_comparison(p, p, backend="gsplat", n_views=1, image_size=16,
                                         device="cpu") == {}
    with pytest.raises(ValueError, match="unknown render backend"):
        trender.render_comparison(p, p, backend="cuda")
    assert vars(tconf.RenderEvalConfig()) == vars(jconf.RenderEvalConfig())


@pytest.mark.parametrize("backend", ["auto", "preview"])
def test_attribute_ablation_matches_jax(rng, backend):
    """One reconstructed group at a time: per group PSNR within 1e-2 dB
    (the preview renderer sees only means, DC colour and whether the
    opacity clears 0.01, so only the colour group gives a finite PSNR)."""
    n = 150
    p = _params(rng, n, sh_k=16)
    attrs = np.concatenate([p["quats"], p["scales"], p["opacities"][:, None], p["colors"]],
                           axis=1).astype(np.float64)
    noisy = attrs + rng.normal(0, 0.02, attrs.shape)
    kw = dict(n_views=2, image_size=48, backend=backend)
    want = jqa.attribute_ablation(p["means"], attrs, noisy, **kw)
    got = tqa.attribute_ablation(p["means"], attrs, noisy, device="cpu", **kw)
    assert list(got) == list(want) == ["quats", "scales", "opacity", "colors"]
    for k in want:
        assert got[k] == want[k] or abs(got[k] - want[k]) <= 1e-2, (k, got[k], want[k])
    finite = [k for k in got if np.isfinite(got[k])]
    assert finite == (list(got) if backend == "auto" else ["colors"])


def test_render_entry_points_refuse_silent_cpu(monkeypatch, rng):
    monkeypatch.setattr(tdev, "cuda_available", lambda: False)
    p = _params(rng, 10)
    vms, Ks, W, H = jcam.generate_random_cameras(np.zeros(3), 2.5, 1, 16, 16)
    for fn in (trender.point_render, trender.volumetric_render):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(p, vms, Ks, W, H)
    for backend in ("auto", "jax", "preview"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trender.render_comparison(p, p, n_views=1, image_size=16, backend=backend)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tqa.attribute_ablation(p["means"], np.zeros((10, 56)), np.zeros((10, 56)))


def test_volumetric_render_counts_views_chunks_and_syncs(rng):
    p = _params(rng, 80)
    vms, Ks, W, H = jcam.generate_random_cameras(np.zeros(3), 2.5, 3, 32, 32, seed=2)
    tr.reset_counts()
    trender.volumetric_render(p, vms, Ks, W, H, device="cpu")
    c = dict(tr.COUNTS)
    assert c["views"] == 3 and c["chunks"] >= 3
    # per view: the chunk conditions, the image copy and the overflow read
    assert c["syncs"] >= c["chunks"] + 2 * 3
