"""The port's tiled rasterizer and its serving path against the plain
float64 reference rasterizer of the benchmark (``portbench/reference/
raster.py``, nothing of the program), on the CPU at small sizes: square
and non-square images (a height that is not a multiple of the 16-pixel
tile leaves the last tile row partial), capacities that clip and that do
not (the clip counts equal), one isotropic Gaussian against its closed
form, and the rasterizer's ``COUNTS`` against the program counters that
feed from the same increments."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.reference import raster as ref
from portbench.reference import serve as refserve
from raht3dgs_tpu_torch.codec.geometry import geometry_from_positions
from raht3dgs_tpu_torch.eval import cameras, rasterize
from raht3dgs_tpu_torch.models.gs_codec import encode_gs_frame
from raht3dgs_tpu_torch.models.gs_voxelize import compress_to_nvox
from raht3dgs_tpu_torch.models.serving import serve_sequence
from raht3dgs_tpu_torch.utils import synth, timing

# float32 rasterizer against float64: a colour (O(1)) differs by ~1e-6;
# 2e-5 leaves room for a longer blend and stays far below 1/255
IMAGE_TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    rasterize.reset_counts()
    timing.reset()
    yield
    timing.reset()
    torch.set_num_threads(n)


def _scene(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    c = rng.normal(0.0, 0.3, (n, 16, 3))
    c[:, 0] = rng.uniform(-1.5, 1.5, (n, 3))
    arrays = (rng.uniform(-0.5, 0.5, (n, 3)), q / np.linalg.norm(q, axis=1, keepdims=True),
              np.exp(rng.normal(-3.5, 0.5, (n, 3))), rng.uniform(0.05, 1.0, n), c)
    return [torch.tensor(a, dtype=torch.float32) for a in arrays]


def _tiled(scene, vm, K, W, H, M, cap):
    f32 = torch.float32
    return rasterize._rasterize_tiled(
        *scene[:4], scene[4], torch.tensor(vm, dtype=f32), torch.tensor(K, dtype=f32),
        torch.ones(3), width=W, height=H, sh_degree=3, tile=16, max_tiles_per_gauss=M,
        max_per_tile=cap, chunk=128)


@pytest.mark.parametrize("W,H,M,cap,clips", [
    (64, 64, 16, 8192, False),
    (88, 40, 16, 8192, False),
    (64, 64, 4, 30, True),
    (88, 40, 4, 30, True),
], ids=["square", "partial-row", "square-clipped", "partial-row-clipped"])
def test_tiled_matches_reference(W, H, M, cap, clips):
    scene = _scene()
    vms, Ks, _, _ = cameras.generate_random_cameras(np.zeros(3), 2.0, 2, W, H, seed=1)
    for vm, K in zip(vms, Ks):
        before = rasterize.COUNTS["entries"]
        img, meta = _tiled(scene, vm, K, W, H, M, cap)
        want, view = ref.render([a.double() for a in scene], vm, K, W, H,
                                max_tiles_per_gauss=M, max_per_tile=cap)
        assert img.shape == (H, W, 3)
        assert float((img.double() - want).abs().max()) <= IMAGE_TOL
        counts = (int(meta.dup_clipped), int(meta.tile_clipped))
        assert counts == (view.dup_clipped, view.tile_clipped)
        assert (min(counts) > 0) == clips and (max(counts) > 0) == clips
        assert rasterize.COUNTS["entries"] - before == view.entries


def test_isotropic_gaussian_closed_form():
    """One isotropic Gaussian on the optical axis, DC colour only: a
    pixel's colour is ``a c + (1 - a) bg`` with ``a = o exp(-d^2 / (2
    s^2))`` and ``s^2 = (f sigma / z)^2 + 0.3``."""
    W = H = 48
    f, z, sigma, o, c = 40.0, 2.0, 0.1, 0.8, 0.7
    vm, K = np.eye(4), np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    vm[2, 3] = z
    colors = np.zeros((1, 16, 3))
    colors[0, 0] = (c - 0.5) / ref.SH_C0
    scene = [torch.tensor(a, dtype=torch.float64) for a in (
        [[0.0, 0.0, 0.0]], [[1.0, 0.0, 0.0, 0.0]], [[sigma] * 3], [o], colors)]
    y, x = np.mgrid[0:H, 0:W] + 0.5
    s2 = (f * sigma / z) ** 2 + 0.3
    a = o * np.exp(-((x - W / 2) ** 2 + (y - H / 2) ** 2) / (2 * s2))
    a = np.where(a >= 1 / 255, a, 0.0)[..., None]
    r = np.ceil(3 * np.sqrt(s2))
    box = ((np.floor((W / 2 - r) / 16) <= x // 16) & (x // 16 <= np.floor((W / 2 + r) / 16))
           & (np.floor((H / 2 - r) / 16) <= y // 16) & (y // 16 <= np.floor((H / 2 + r) / 16)))
    want = np.where(box[..., None], a * c + (1 - a), 1.0)
    img, meta = _tiled([t.float() for t in scene], vm, K, W, H, 16, 8192)
    got, view = ref.render(scene, vm, K, W, H)
    assert np.abs(got.numpy() - want).max() < 1e-12
    assert np.abs(img.numpy() - want).max() < IMAGE_TOL
    assert view.dup_clipped == view.tile_clipped == 0 == int(meta.dup_clipped)


def _stream(depth=7, n=4000):
    """A merged scene coded at step 1 in float32 with its geometry section,
    as ``encode_3dgs --code-geometry --save-streams`` writes it, with the
    voxels the reference decodes it at."""
    c = compress_to_nvox(synth.gaussian_scene(n, seed=3), depth=depth, device="cpu")
    V = c.positions_int[:c.n_voxels]
    pay = np.concatenate([c.quats, c.scales, c.opacities[:, None], c.colors],
                         axis=1)[:c.n_voxels]
    (pt,) = encode_gs_frame(V, pay, depth=depth, steps=[1.0], bucket=256,
                            dtype=torch.float32, keep_streams=True, vmin=c.vmin,
                            width=float(c.voxel_size) * (1 << depth), device="cpu")
    st = pt.encoded.stream
    st.geometry = geometry_from_positions(V, depth)
    return {"V": V, "vmin": np.asarray(c.vmin, np.float64), "voxel_size": float(c.voxel_size),
            "blob": st.to_bytes(), "width": float(st.width)}


@pytest.fixture(scope="module")
def stream():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _stream()
    finally:
        torch.set_num_threads(n)


def _serve(s, W, H, views=2, **kw):
    # an orbit wide enough to hold the whole scene in view
    vms, Ks, _, _ = cameras.generate_random_cameras(
        s["vmin"] + s["width"] / 2, 3.0 * s["width"] / 2, views, W, H, seed=5)
    (out,) = list(serve_sequence([s["blob"]], vms, Ks, width=W, height=H,
                                 image_dtype=torch.uint8, device="cpu", **kw))
    return out, vms, Ks


@pytest.mark.parametrize("W,H,caps", [
    (96, 96, {}),
    (120, 72, {}),
    (120, 72, {"max_tiles_per_gauss": 1, "max_per_tile": 8}),
], ids=["square", "partial-row", "partial-row-clipped"])
def test_serve_sequence_matches_reference(stream, W, H, caps):
    """``serve_sequence`` of one ``.r3tc`` with geometry, uint8, against the
    reference's float64 decode of the same stream rendered in float64."""
    (imgs, dups, tiles), vms, Ks = _serve(stream, W, H, **caps)
    nums, scene = refserve.served_scene(stream["blob"], stream["V"], stream["voxel_size"],
                                        stream["vmin"], depth=7, channels=56, step=1)
    assert nums == {"header_diff": 0.0}
    for v in range(len(vms)):
        want, view = ref.render(scene, vms[v], Ks[v], W, H, **caps)
        got = imgs[v].numpy().astype(np.int16)
        diff = np.abs(got - ref.display_u8(want).numpy().astype(np.int16))
        # a float32 colour within ~1e-6 of the float64 one truncates to the
        # same level unless it lies that close to a level's edge
        assert diff.max() <= 1 and diff.mean() < 1e-3
        assert (int(dups[v]), int(tiles[v])) == (view.dup_clipped, view.tile_clipped)
        assert (view.dup_clipped > 0 and view.tile_clipped > 0) == bool(caps)


def test_counters_and_spans_of_a_served_frame(stream):
    """Under a profiler the rasterizer's ``COUNTS`` and the program counters
    ``raster_*`` take the same increments, and a served frame is one
    ``serve`` root with its children and a ``render`` a view."""
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(stream, 120, 72, views=3)
    snap = timing.snapshot()
    for name in ("views", "chunks", "syncs", "entries"):
        assert snap["counts"]["raster_" + name] == rasterize.COUNTS[name] > 0
    assert rasterize.COUNTS["views"] == 3
    sp = snap["spans"]
    assert sp["serve"]["calls"] == sp["serve"]["roots"] == 1
    for name in ("geometry", "rlgr_decode", "upload", "inverse"):
        assert sp[name]["calls"] >= 1 and sp[name]["roots"] == 0
    for name in ("render", "project", "bin", "blend"):
        assert sp[name]["calls"] == 3 and sp[name]["roots"] == 0
    rasterize.reset_counts()
    timing.reset()
    _serve(stream, 120, 72, views=1)  # no profiler: COUNTS alone
    assert rasterize.COUNTS["views"] == 1 and timing.snapshot() == {"spans": {}, "counts": {}}
