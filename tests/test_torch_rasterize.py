"""The port's cameras and volumetric rasterizer against the JAX package's.

Each case feeds the same numpy inputs (from a seed) to
``raht3dgs_tpu.eval`` on the CPU and to ``raht3dgs_tpu_torch.eval`` with
``device="cpu"``. Tolerances: cameras byte-equal; SH colours to rtol 1e-6
(the same float32 formula); projection to rtol 1e-5 (XLA contracts the
3-term dot products into fused multiply-adds, the port adds three
products) with radii and the alive mask equal; images to atol 5e-5 (the
blend's cumprod and colour sums group differently) with RasterMeta,
budgets and compaction widths equal. Within the port: tiled == dense to
atol 2e-5, compaction and the early exit bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raht3dgs_tpu.eval import cameras as jcam, rasterize as jr
from raht3dgs_tpu_torch.eval import cameras as tcam, rasterize as tr
from raht3dgs_tpu_torch.utils import device as tdev

from _raster_oracle import eval_sh_oracle, render_oracle
from test_rasterize import _front_cam, _random_scene

_IMG_TOL = 5e-5


def _meta(meta):
    return int(meta.dup_clipped), int(meta.tile_clipped)


def _both(scene, viewmat, K, W, H, **kw):
    """One view through both packages: (jax image, port image, jax meta,
    port meta)."""
    a, ma = jr.rasterize_gaussians(*scene, viewmat, K, W, H, **kw)
    b, mb = tr.rasterize_gaussians(*scene, viewmat, K, W, H, device="cpu", **kw)
    return np.asarray(a), b, _meta(ma), _meta(mb)


@pytest.mark.parametrize("n_views,w,h,seed,center,radius", [
    (5, 512, 512, 0, (0.1, -0.3, 2.0), 3.7),
    (3, 64, 48, 11, (0.0, 0.0, 0.0), 2.5),
])
def test_cameras_byte_equal(n_views, w, h, seed, center, radius):
    a = jcam.generate_random_cameras(np.array(center), radius, n_views, w, h, seed=seed)
    b = tcam.generate_random_cameras(np.array(center), radius, n_views, w, h, seed=seed)
    assert a[2:] == b[2:]
    for x, y in zip(a[:2], b[:2]):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    # the degenerate look-at (forward parallel to the world up) too
    up = np.array([0.0, 5.0, 0.0])
    assert jcam.look_at_w2c(up, np.zeros(3)).tobytes() == \
        tcam.look_at_w2c(up, np.zeros(3)).tobytes()


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_jax_and_oracle(rng, degree):
    K = (degree + 1) ** 2
    sh = rng.normal(size=(64, K, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = tr.eval_sh(torch.from_numpy(sh), torch.from_numpy(d), degree).numpy()
    want = np.asarray(jr.eval_sh(jnp.asarray(sh), jnp.asarray(d), degree))
    # up to 16 float32 terms of magnitude ~3, which XLA contracts into
    # fused multiply-adds: 1e-6 absolute where they cancel towards 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    sh64 = sh.astype(np.float64)
    d64 = d / np.linalg.norm(d.astype(np.float64), axis=1, keepdims=True)
    got64 = tr.eval_sh(torch.from_numpy(sh64), torch.from_numpy(d64), degree).numpy()
    want64 = np.asarray(jr.eval_sh(jnp.asarray(sh64), jnp.asarray(d64), degree))
    np.testing.assert_allclose(got64, want64, rtol=1e-12, atol=1e-14)
    # the hard-coded constant table against the Legendre derivation
    np.testing.assert_allclose(got64, eval_sh_oracle(sh64, d64, degree), atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["random_cams", "front_needles"])
def test_project_gaussians_matches_jax(rng, kind, dtype):
    """float32, as the rasterizer runs it, and float64. The float32 conic
    is held to 1e-4: its determinant a*c - b^2 cancels for elongated
    splats, and XLA contracts it (and J M J^T) into fused multiply-adds."""
    means, quats, scales, opac, _ = _random_scene(rng, 300, scale_lo=0.005, scale_hi=0.4)
    if kind == "random_cams":
        vms, Ks, W, H = jcam.generate_random_cameras(np.zeros(3), 2.5, 1, 64, 64, seed=4)
        viewmat, K = vms[0], Ks[0]
    else:
        scales[:, 1] *= 0.02
        viewmat, K = _front_cam(width=70, height=50)
        W, H = 70, 50
    args = [np.asarray(x, dtype) for x in (means, quats, scales, opac, viewmat, K)]
    want = [np.asarray(x) for x in jr.project_gaussians(*map(jnp.asarray, args), W, H)]
    got = [x.numpy() for x in tr.project_gaussians(*map(torch.from_numpy, args), W, H)]
    names = ("means2d", "conic", "depths", "radii", "alive", "vd", "lam1")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype, name
        if name in ("radii", "alive"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            rtol = 1e-4 if name == "conic" and dtype == np.float32 else 1e-5
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6, err_msg=name)
    assert got[4].any()


def _nan_inf_scene(rng):
    """One Gaussian whose footprint is out of int32 range in tile units on
    one side (scale 1.15e8, far to the right: r ~ 1.77e10, mx ~ 1.72e10,
    so (mx + r) / 16 > 2^31 while mx - r < width keeps it alive), one NaN
    mean, the rest ordinary."""
    means, quats, scales, opac, colors = _random_scene(rng, 60)
    quats[0] = [1, 0, 0, 0]
    scales[0] = [1.15e8, 0.05, 0.05]
    means[0] = [3.35e8, 0.0, 0.0]
    means[1] = np.nan
    return means, quats, scales, opac, colors


def _scene(kind, rng):
    """(scene, viewmat, K, W, H, rasterize kwargs) of each scene kind of
    ``tests/test_rasterize.py``, plus the cast scene."""
    if kind in ("sh1", "sh16"):
        scene = _random_scene(rng, 160, sh_k=1 if kind == "sh1" else 16)
        vms, Ks, W, H = jcam.generate_random_cameras(np.zeros(3), 2.5, 1, 64, 64, seed=3)
        return scene, vms[0], Ks[0], W, H, {}
    if kind == "super_unit_opacity":
        means, quats, scales, opac, colors = _random_scene(rng, 96)
        scene = (means, quats, scales, (opac * 40.0 + 2.0).astype(np.float32), colors)
        return scene, *_front_cam(), 64, 64, {}
    if kind == "nonmultiple_size":
        return _random_scene(rng, 120), *_front_cam(width=70, height=50), 70, 50, {}
    if kind == "empty_behind_camera":
        scene = (np.array([[0, 0, -10.0]], np.float32), np.array([[1, 0, 0, 0]], np.float32),
                 np.full((1, 3), 0.1, np.float32), np.array([1.0], np.float32),
                 np.zeros((1, 3), np.float32))
        return scene, *_front_cam(width=32, height=32), 32, 32, {}
    if kind == "anisotropic":
        means, quats, scales, opac, colors = _random_scene(rng, 60, sh_k=4, scale_lo=0.005,
                                                           scale_hi=0.3)
        scales[:, 0] *= 0.05
        return (means, quats, scales, opac, colors), *_front_cam(), 64, 64, {}
    if kind == "nan_inf_cast":
        viewmat, K = _front_cam(width=128, height=128)
        return _nan_inf_scene(rng), viewmat, K, 128, 128, {"max_tiles_per_gauss": 64}
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["sh1", "sh16", "super_unit_opacity", "nonmultiple_size",
                                  "empty_behind_camera", "anisotropic", "nan_inf_cast"])
def test_rasterize_matches_jax(rng, kind):
    scene, viewmat, K, W, H, kw = _scene(kind, rng)
    a, b, ma, mb = _both(scene, viewmat, K, W, H, **kw)
    assert b.shape == (H, W, 3) and b.dtype == np.float32
    assert mb == ma
    np.testing.assert_allclose(b, a, atol=_IMG_TOL)
    if kind == "nan_inf_cast":
        # the huge footprint spans the whole 8 x 8 grid in both (int32
        # saturation in XLA, the float clamp in the port)
        assert ma == (0, 0) and jr.auto_tile_budget(
            *scene[:4], viewmat, K, width=W, height=H) == 64
        assert tr.auto_tile_budget(*scene[:4], viewmat, K, width=W, height=H,
                                   device="cpu") == 64
        _, m32 = tr.rasterize_gaussians(*scene, viewmat, K, W, H, device="cpu")
        assert _meta(m32) == (32, 0)
    if kind == "empty_behind_camera":
        np.testing.assert_allclose(b, 1.0, atol=1e-6)
    d = tr.rasterize_dense(*scene, viewmat, K, W, H, device="cpu")
    if kind == "nan_inf_cast":
        # the cull floors the conic at 1e-12 (A is 3e-20 for the huge
        # footprint), so in both packages the tiled image drops its faint
        # band and differs from the dense one; the dense images agree
        jd = np.asarray(jr.rasterize_dense(*scene, viewmat, K, W, H))
        np.testing.assert_allclose(d, jd, atol=_IMG_TOL)
        assert np.abs(np.asarray(a) - jd).max() > 1e-3
    elif mb == (0, 0):
        np.testing.assert_allclose(b, d, atol=2e-5)


@pytest.mark.parametrize("values", [
    [np.inf, -np.inf, np.nan, 1e30, -1e30, 5e10, -5e10, 3.4e10],
    [0.0, 15.99, 16.0, -0.01, 127.9, 128.0, -16.0, 1e9],
])
def test_tile_bbox_casts_match_jax(values):
    """XLA saturates inf and out-of-range values and maps NaN to 0; the
    port clamps in float first (torch's CPU cast gives INT_MIN for all of
    them), so every tile index agrees."""
    v = np.array(values, np.float32)
    mx = np.concatenate([v, np.full_like(v, 64.0)])
    my = np.concatenate([np.full_like(v, 64.0), v])
    r = np.concatenate([np.full_like(v, 3.0), np.where(np.isfinite(v), 3.0, v)])
    want = jr._tile_bbox(jnp.asarray(mx), jnp.asarray(my), jnp.asarray(r), 16, 8, 8)
    got = tr._tile_bbox(torch.from_numpy(mx), torch.from_numpy(my), torch.from_numpy(r),
                        16, 8, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _needles(rng, n=60, W=256):
    """Diagonal needles: the anisotropic cull shrinks the post-cull width
    below the bbox budget, so compaction engages."""
    means = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    means[:, 2] *= 0.2
    a = np.pi / 4
    quats = np.tile([np.cos(a / 2), 0, 0, np.sin(a / 2)], (n, 1)).astype(np.float32)
    scales = np.tile([0.6, 0.008, 0.008], (n, 1)).astype(np.float32)
    opac = np.full(n, 0.9, np.float32)
    colors = rng.normal(0, 0.5, size=(n, 3)).astype(np.float32)
    return (means, quats, scales, opac, colors), *_front_cam(width=W, height=W), W, W


@pytest.mark.parametrize("kind", ["needles", "small_splats"])
def test_auto_budget_and_compaction_width_match_jax(rng, kind):
    if kind == "needles":
        scene, viewmat, K, W, H = _needles(rng)
    else:
        means, quats, scales, opac, colors = _random_scene(rng, 150, spread=0.8)
        scene = (means, quats, scales * 0.3, opac, colors)
        viewmat, K = _front_cam(dist=2.5)
        W = H = 64
    budget = jr.auto_tile_budget(*scene[:4], viewmat, K, width=W, height=H)
    assert tr.auto_tile_budget(*scene[:4], viewmat, K, width=W, height=H,
                               device="cpu") == budget
    want = int(jr._max_valid_cover(*map(jnp.asarray, (*scene[:4], viewmat, K)), width=W,
                                   height=H, tile=16, m=budget))
    got = int(tr._max_valid_cover(*map(torch.from_numpy, (*scene[:4], viewmat, K)),
                                  width=W, height=H, tile=16, m=budget))
    assert got == want
    a, b, ma, mb = _both(scene, viewmat, K, W, H, max_tiles_per_gauss="auto")
    assert mb == ma == (0, 0)
    np.testing.assert_allclose(b, tr.rasterize_dense(*scene, viewmat, K, W, H, device="cpu"),
                               atol=2e-5)
    if kind == "needles":
        assert want <= budget // 2  # the compaction engages
        # the needles' quadratic form cancels along their axis, where XLA's
        # fused multiply-adds round differently: 5e-3 between packages
        np.testing.assert_allclose(b, a, atol=5e-3)
    else:
        np.testing.assert_allclose(b, a, atol=_IMG_TOL)


def test_compaction_bitwise_equal_to_none(rng, monkeypatch):
    scene, viewmat, K, W, H = _needles(rng)
    tr.reset_counts()
    comp, m1 = tr.rasterize_gaussians(*scene, viewmat, K, W, H, max_tiles_per_gauss="auto",
                                      device="cpu")
    assert tr.COUNTS["syncs"] >= 3  # two probes, the chunk conditions, the image
    monkeypatch.setenv("RAHT3DGS_RASTER_COMPACT", "0")
    base, m0 = tr.rasterize_gaussians(*scene, viewmat, K, W, H, max_tiles_per_gauss="auto",
                                      device="cpu")
    np.testing.assert_array_equal(comp, base)
    assert _meta(m1) == _meta(m0) == (0, 0)


def test_cull_off_matches_jax_and_cull(rng, monkeypatch):
    """RAHT3DGS_RASTER_CULL=0 keeps every bbox entry, as in the JAX
    package; the cull only drops exact-zero contributions."""
    scene = _random_scene(rng, 250, sh_k=4, scale_lo=0.02, scale_hi=0.5)
    viewmat, K = _front_cam()
    kw = dict(max_tiles_per_gauss=64)
    culled, mc = tr.rasterize_gaussians(*scene, viewmat, K, 64, 64, device="cpu", **kw)
    monkeypatch.setenv("RAHT3DGS_RASTER_CULL", "0")
    jr._rasterize_tiled.clear_cache()
    try:
        a, b, ma, mb = _both(scene, viewmat, K, 64, 64, **kw)
    finally:
        monkeypatch.delenv("RAHT3DGS_RASTER_CULL")
        jr._rasterize_tiled.clear_cache()
    assert mb == ma and _meta(mc)[0] == mb[0] and _meta(mc)[1] <= mb[1]
    np.testing.assert_allclose(b, a, atol=_IMG_TOL)
    np.testing.assert_allclose(culled, b, atol=2e-6)


@pytest.mark.parametrize("pair_sort", ["0", "1"])
def test_int64_key_bins_as_both_jax_sorts(rng, monkeypatch, pair_sort):
    """The port's single int64 key sort against the JAX package's packed
    uint32 sort and its stable pair sort: with a tile capacity that clips,
    which entries a tile keeps, and the blend, depend on each segment's
    exact order."""
    scene = _random_scene(rng, 300, sh_k=1)
    viewmat, K = _front_cam(width=48, height=48)
    kw = dict(max_per_tile=24, chunk=8)
    monkeypatch.setenv("RAHT3DGS_RASTER_PAIR_SORT", pair_sort)
    jr._rasterize_tiled.clear_cache()
    try:
        a, b, ma, mb = _both(scene, viewmat, K, 48, 48, **kw)
    finally:
        monkeypatch.delenv("RAHT3DGS_RASTER_PAIR_SORT")
        jr._rasterize_tiled.clear_cache()
    assert mb == ma and ma[1] > 0
    np.testing.assert_allclose(b, a, atol=_IMG_TOL)


def _opaque_stack(rng, n=400):
    """Wide opaque splats stacked in depth over the image: every pixel's
    transmittance underflows to 0.0 within ~100 of the 400 entries a tile
    holds."""
    means = rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    means[:, 2] = np.linspace(-0.5, 0.5, n, dtype=np.float32)
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    scales = np.full((n, 3), 2.0, np.float32)
    opac = np.full(n, 0.99, np.float32)
    colors = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    return means, quats, scales, opac, colors


@pytest.mark.parametrize("kind", ["opaque_stack", "random"])
def test_early_exit_is_exact(rng, kind):
    scene = _opaque_stack(rng) if kind == "opaque_stack" else _random_scene(rng, 200)
    viewmat, K = _front_cam()
    t = [torch.from_numpy(x) for x in scene]
    sh, deg = tr._colors_to_sh(t[4])
    kw = dict(width=64, height=64, sh_degree=deg, tile=16, max_tiles_per_gauss=32,
              max_per_tile=512, chunk=16)
    args = (*t[:4], sh, torch.from_numpy(viewmat), torch.from_numpy(K), torch.ones(3))
    tr.reset_counts()
    early, me = tr._rasterize_tiled(*args, **kw)
    chunks_early = tr.COUNTS["chunks"]
    full, mf = tr._rasterize_tiled(*args, early_exit=False, **kw)
    chunks_full = tr.COUNTS["chunks"] - chunks_early
    assert torch.equal(early, full) and _meta(me) == _meta(mf) == (0, 0)
    assert chunks_early <= chunks_full
    if kind == "opaque_stack":
        assert chunks_early < chunks_full
    a, _ = jr.rasterize_gaussians(*scene, viewmat, K, 64, 64, max_per_tile=512, chunk=16)
    np.testing.assert_allclose(early.numpy(), np.asarray(a), atol=_IMG_TOL)


@pytest.mark.parametrize("caps", [
    dict(max_tiles_per_gauss=1),
    dict(max_per_tile=2),
    dict(max_tiles_per_gauss=2, max_per_tile=3, chunk=2),
])
def test_forced_small_capacities_count_as_jax(rng, caps):
    scene = _random_scene(rng, 120, scale_lo=0.05, scale_hi=0.3)
    viewmat, K = _front_cam()
    a, b, ma, mb = _both(scene, viewmat, K, 64, 64, **caps)
    assert mb == ma and ma != (0, 0)
    np.testing.assert_allclose(b, a, atol=_IMG_TOL)


def test_forced_compaction_width_counts_as_jax(rng):
    means, quats, scales, opac, colors = _random_scene(rng, 120)
    scales[:, 0] *= 8.0
    viewmat, K = _front_cam()
    kw = dict(width=64, height=64, sh_degree=0, tile=16, max_tiles_per_gauss=32,
              max_per_tile=1024, chunk=128, compact_tiles=4)
    a, ma = jr._rasterize_tiled(*map(jnp.asarray, (means, quats, scales, opac)),
                                jnp.asarray(colors).reshape(-1, 1, 3), jnp.asarray(viewmat),
                                jnp.asarray(K), jnp.ones(3, jnp.float32), **kw)
    b, mb = tr._rasterize_tiled(*map(torch.from_numpy, (means, quats, scales, opac)),
                                torch.from_numpy(colors).reshape(-1, 1, 3),
                                torch.from_numpy(viewmat), torch.from_numpy(K),
                                torch.ones(3), **kw)
    assert _meta(mb) == _meta(ma) and _meta(ma)[0] > 0
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=_IMG_TOL)


def test_tiled_matches_independent_oracle(rng):
    """The port's tiled image against the numpy brute-force renderer,
    which shares no code with either package (tolerances of
    ``tests/test_raster_oracle.py``: float32 against float64 at the 1/255
    cutoff)."""
    means, quats, scales, opac, colors = _random_scene(rng, 60, sh_k=4)
    vms, Ks, W, H = tcam.generate_random_cameras(np.zeros(3), 2.5, 1, 32, 32, seed=7)
    img, meta = tr.rasterize_gaussians(means, quats, scales, opac, colors, vms[0], Ks[0],
                                       W, H, device="cpu")
    assert _meta(meta) == (0, 0)
    ref = render_oracle(means, quats, scales, opac, colors.reshape(60, 4, 3).astype(np.float64),
                        vms[0], Ks[0], W, H, 1)
    diff = np.abs(img - ref)
    assert diff.max() < 5e-3 and diff.mean() < 2e-4


def test_rasterize_refuses_silent_cpu(monkeypatch, rng):
    monkeypatch.setattr(tdev, "cuda_available", lambda: False)
    scene = _random_scene(rng, 10)
    viewmat, K = _front_cam(width=32, height=32)
    for fn in (tr.rasterize_gaussians, tr.rasterize_dense):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(*scene, viewmat, K, 32, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.auto_tile_budget(*scene[:4], viewmat, K, width=32, height=32)
    # tensors on the CPU are the caller's explicit choice
    img, _ = tr.rasterize_gaussians(*map(torch.from_numpy, scene), torch.from_numpy(viewmat),
                                    torch.from_numpy(K), 32, 32)
    assert img.shape == (32, 32, 3)
