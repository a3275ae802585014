"""View-sharded rendering and serving (``parallel/render.py``,
``serve_views_sharded`` and the ``mesh=`` branches of ``serve_tiled_frame``
and ``serve_sequence``) over a virtual mesh of 4 CPU slots, 5 views padded
to 8.

Tolerances: images bitwise the port's unsharded calls, clip counts equal;
against the JAX package's sharded calls (4 of the 8 CPU devices of
``tests/conftest.py``) the tolerances of ``tests/test_torch_serving.py``:
5e-5 for plain frames and bricks, 1e-4 for predicted ones, 2e-4 for I/P
sequences, one level for uint8 images; clip counts equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raht3dgs_tpu.eval.cameras import generate_random_cameras
from raht3dgs_tpu.models import serving as js
from raht3dgs_tpu.parallel import render as jrender
from raht3dgs_tpu.parallel.sharding import make_mesh as jax_mesh
from raht3dgs_tpu_torch.eval import rasterize as tr
from raht3dgs_tpu_torch.models import serving as ts
from raht3dgs_tpu_torch.parallel import render as trender
from raht3dgs_tpu_torch.parallel.sharding import make_mesh
from test_rasterize import _random_scene
from test_torch_serving import (  # noqa: F401  (module fixtures)
    DEPTH, PLAIN_TOL, PREDICT_TOL, RASTER, SEQ_TOL, SIZE, STEP, VMIN, _cameras, _max_diff,
    _not_blank, _one_thread, _sequence, served, tiled)

VIEWS = 5


@pytest.fixture(scope="module")
def meshes():
    return jax_mesh(4), make_mesh(4, devices=[torch.device("cpu")] * 4)


def _equal(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_render_views_sharded_matches(rng, meshes):
    """Every view bitwise ``rasterize_gaussians`` on one device, overflow
    counts equal; within 5e-5 of the JAX package's sharded render."""
    jmesh, mesh = meshes
    scene = _random_scene(rng, 300, sh_k=16)
    vms, Ks, _, _ = generate_random_cameras(np.zeros(3), 3.0, VIEWS, 32, 32, seed=3)
    imgs, meta = trender.render_views_sharded(*scene, vms, Ks, 32, 32, mesh=mesh)
    assert imgs.shape == (VIEWS, 32, 32, 3) and meta.dup_clipped.shape == (VIEWS,)
    for v in range(VIEWS):
        img, m = tr.rasterize_gaussians(*scene, vms[v], Ks[v], 32, 32, device="cpu")
        np.testing.assert_array_equal(imgs[v].numpy(), img)
        assert (int(meta.dup_clipped[v]), int(meta.tile_clipped[v])) == \
            (int(m.dup_clipped), int(m.tile_clipped))
    _not_blank(imgs.numpy())
    jimgs, jmeta = jrender.render_views_sharded(*scene, vms, Ks, 32, 32, mesh=jmesh)
    assert _max_diff(imgs.numpy(), jimgs) <= PLAIN_TOL
    np.testing.assert_array_equal(meta.dup_clipped.numpy(), jmeta.dup_clipped)
    np.testing.assert_array_equal(meta.tile_clipped.numpy(), jmeta.tile_clipped)


@pytest.mark.parametrize("image_dtype", ["f32", "u8"])
def test_serve_views_sharded_matches(served, meshes, image_dtype):
    """Each slot decodes the frame itself: the images bitwise
    ``serve_frame``'s, within 5e-5 (uint8: one level) of the JAX package's
    ``serve_views_sharded``."""
    jmesh, mesh = meshes
    jf, tf, p = served["jf"], served["tf"], served["plain"]
    vms, Kms = _cameras(VIEWS)
    u8 = image_dtype == "u8"
    kw = dict(depth=DEPTH, width=SIZE, height=SIZE, **RASTER)
    args = (p["vals_T"], p["t_inv"], STEP, tf.codes, tf.weights, served["vs"], VMIN, vms, Kms)
    got = ts.serve_views_sharded(*args, mesh=mesh, image_dtype=torch.uint8 if u8 else
                                 torch.float32, **kw)
    _equal(got, ts.serve_frame(*args, image_dtype=torch.uint8 if u8 else torch.float32,
                               **kw))
    ji, jd, jt = js.serve_views_sharded(
        jnp.asarray(p["vals_T"]), p["j_inv"], jnp.float32(STEP), jf.codes, jf.weights,
        jnp.float32(served["vs"]), jnp.asarray(VMIN, jnp.float32), vms, Kms, mesh=jmesh,
        image_dtype=jnp.uint8 if u8 else jnp.float32, **kw)
    assert got[0].shape == (VIEWS, SIZE, SIZE, 3)
    assert _max_diff(got[0].numpy(), np.asarray(ji)) <= (1 if u8 else PLAIN_TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jd))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jt))
    if not u8:
        _not_blank(got[0].numpy())


@pytest.mark.parametrize("kind", ["plain", "predict"])
def test_serve_tiled_frame_mesh_matches(tiled, meshes, kind):
    """Every brick and one brick (``bricks=[1]``): bitwise the unsharded
    serve, within 5e-5 (plain) / 1e-4 (predicted) of the JAX package's
    ``serve_tiled_frame(mesh=)``, the selections equal."""
    jmesh, mesh = meshes
    tol = PLAIN_TOL if kind == "plain" else PREDICT_TOL
    vms, Kms = _cameras(VIEWS)
    for sel_kw in (dict(margin=4.0), dict(bricks=[1])):
        kw = dict(width=SIZE, height=SIZE, bucket=64, **sel_kw, **RASTER)
        got = ts.serve_tiled_frame(tiled[kind], vms, Kms, mesh=mesh, **kw)
        want = ts.serve_tiled_frame(tiled[kind], vms, Kms, device="cpu", **kw)
        assert got[3] == want[3]
        _equal(got[:3], want[:3])
        ji, jd, jt, jsel = js.serve_tiled_frame(tiled[kind], jnp.asarray(vms),
                                                jnp.asarray(Kms), mesh=jmesh, **kw)
        assert got[3] == jsel
        assert _max_diff(got[0].numpy(), np.asarray(ji)) <= tol
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(jt))
    _not_blank(got[0].numpy())


def test_serve_sequence_mesh_matches(meshes):
    """I P P playback with each frame's views sharded: bitwise the
    unsharded playback, within 2e-4 of the JAX package's
    ``serve_sequence(mesh=)``."""
    jmesh, mesh = meshes
    positions, frames, streams, _ = _sequence(np.random.default_rng(2))
    width = float(frames[0].width)
    vms, Kms = _cameras(VIEWS, center=np.asarray(frames[0].vmin) + width / 2,
                        radius=0.7 * width)
    kw = dict(width=SIZE, height=SIZE, positions=positions, bucket=64, **RASTER)
    blobs = [s.to_bytes() for s in streams]
    got = list(ts.serve_sequence(blobs, vms, Kms, mesh=mesh, **kw))
    want = list(ts.serve_sequence(blobs, vms, Kms, device="cpu", **kw))
    J = list(js.serve_sequence(streams, jnp.asarray(vms), jnp.asarray(Kms), mesh=jmesh, **kw))
    assert len(got) == len(want) == len(J) == 3
    for g, w, j in zip(got, want, J):
        _equal(g, w)
        _not_blank(g[0].numpy())
        assert _max_diff(g[0].numpy(), np.asarray(j[0])) <= SEQ_TOL
        np.testing.assert_array_equal(g[1].numpy(), np.asarray(j[1]))
