"""The port's 3DGS path against the JAX package's: the Gaussian merge, the
fused voxelize + merge, the 56-channel RD sweep, the quantization study,
the metrics and the checkpoint loader.

Tolerances: the float64 merge agrees to 1e-12 (same operations, sums in a
different association only where the segment method differs); float32
voxelize + merge gives integer outputs exactly and floats to 1e-5 relative
(one rounding of a norm or a quotient); the RD sweep is held to the gate of
ROADMAP queue A, item 6 (symbols equal except within 1e-9 (f64) / 1e-5
(f32) of a quantization tie, streams decoding across both packages both
ways, PSNR within 1e-6 dB (f64) / 1e-3 dB (f32)).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raht3dgs_tpu import config as jconf
from raht3dgs_tpu.codec.bitstream import FrameStream as JaxStream
from raht3dgs_tpu.eval import metrics as jmet
from raht3dgs_tpu.io import gsplat_ckpt as jck
from raht3dgs_tpu.models import gs_codec as jgc, gs_merge as jgm, gs_quant_analysis as jqa
from raht3dgs_tpu.models import gs_voxelize as jgv, pipeline as jp
from raht3dgs_tpu.ops import quantize as jq
from raht3dgs_tpu_torch import config as tconf
from raht3dgs_tpu_torch.codec.bitstream import FrameStream
from raht3dgs_tpu_torch.codec.rlgr import rlgr_decode_channels
from raht3dgs_tpu_torch.eval import metrics as tmet
from raht3dgs_tpu_torch.io import gsplat_ckpt as tck
from raht3dgs_tpu_torch.models import gs_codec as tgc, gs_merge as tgm, gs_quant_analysis as tqa
from raht3dgs_tpu_torch.models import gs_voxelize as tgv, pipeline as tp
from raht3dgs_tpu_torch.ops import quantize as tq
from raht3dgs_tpu_torch.utils import synth

_TORCH = {jnp.float64: torch.float64, jnp.float32: torch.float32}
_TIE_TOL = {jnp.float64: 1e-9, jnp.float32: 1e-5}
_REC_TOL = {jnp.float64: 1e-9, jnp.float32: 1e-3}
_PSNR_TOL = {jnp.float64: 1e-6, jnp.float32: 1e-3}
_KEYS = ("means", "quats", "scales", "opacities", "colors")


def _unit(q):
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _scene(rng, n=500):
    return {
        "means": rng.normal(size=(n, 3)),
        "quats": _unit(rng.normal(size=(n, 4))),
        "scales": np.abs(rng.normal(size=(n, 3))) * 0.05,
        "opacities": rng.uniform(0.2, 1.0, size=n),
        "colors": rng.normal(size=(n, 48)),
    }


def _args(scene):
    return [scene[k] for k in _KEYS]


# -- the merge ---------------------------------------------------------------


@pytest.mark.parametrize("weight_by_opacity", [True, False])
def test_merge_matches_jax(rng, weight_by_opacity):
    scene = _scene(rng, 300)
    ids = rng.integers(0, 40, size=300)
    ids[ids == 7] = 8  # an empty cluster: zeros, identity quat, opacity 0
    want = jgm.merge_gaussian_clusters(*(jnp.asarray(a) for a in _args(scene)),
                                       jnp.asarray(ids), num_clusters=40,
                                       weight_by_opacity=weight_by_opacity)
    got = tgm.merge_gaussian_clusters(*(torch.from_numpy(a) for a in _args(scene)),
                                      torch.from_numpy(ids), num_clusters=40,
                                      weight_by_opacity=weight_by_opacity)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got[1][7].numpy(), [0.0, 0.0, 0.0, 1.0])


@pytest.mark.parametrize("partial", [False, True])
def test_csr_merge_matches_jax(rng, partial):
    scene = _scene(rng, 120)
    labels = rng.integers(100, 110, size=120)  # a label space that is not 0..k-1
    idx, off = tgm.prepare_cluster_data(labels)
    jidx, joff = jgm.prepare_cluster_data(labels)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(off, joff)
    if partial:  # a CSR over some of the rows: the rest are dropped
        idx, off = idx[:off[5]], off[:6]
    want = jgm.merge_gaussian_clusters_with_indices(*_args(scene), idx, off)
    got = tgm.merge_gaussian_clusters_with_indices(*_args(scene), idx, off, device="cpu")
    for a, b in zip(got, want):
        assert a.shape[0] == len(off) - 1
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)


# -- voxelize + merge ------------------------------------------------------


def _check_compressed(got, want, ftol=1e-5):
    assert (got.n_voxels, got.n_input) == (want.n_voxels, want.n_input)
    np.testing.assert_array_equal(got.positions_int, np.asarray(want.positions_int))
    np.testing.assert_array_equal(got.cluster_of_input, np.asarray(want.cluster_of_input))
    assert got.voxel_size == want.voxel_size and got.width == want.width
    np.testing.assert_array_equal(got.vmin, want.vmin)
    for f in ("quats", "scales", "opacities", "colors", "means_world"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == np.float32 and a.shape == b.shape, f
        scale = max(float(np.abs(b).max()), 1.0)
        assert float(np.abs(a - b).max()) <= ftol * scale, f
    np.testing.assert_allclose(tgv.world_positions(got), jgv.world_positions(want),
                               rtol=1e-6)


@pytest.mark.parametrize("depth", [4, 6, 10])
def test_compress_to_nvox_matches_jax(rng, tmp_path, depth):
    scene = _scene(rng, 2000)
    want = jgv.compress_to_nvox(scene, depth=depth, output_dir=str(tmp_path / "j"))
    got = tgv.compress_to_nvox(scene, depth=depth, output_dir=str(tmp_path / "t"),
                               device="cpu")
    _check_compressed(got, want)
    assert set(got.timer.stages) == {"voxelize_merge", "save_ply"}
    # the PLYs read back alike through the JAX package's reader
    from raht3dgs_tpu.io.ply import read_compressed_3dgs_ply

    for name in ("original_N_gaussians.ply", "compressed_Nvox_gaussians.ply"):
        a = read_compressed_3dgs_ply(tmp_path / "t" / name)
        b = read_compressed_3dgs_ply(tmp_path / "j" / name)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_allclose(a[1], b[1], rtol=1e-5, atol=1e-6)
        assert a[2] == b[2]
        np.testing.assert_array_equal(a[3], b[3])


@pytest.mark.parametrize("n", [1, 3])
def test_compress_to_nvox_zero_extent_matches_jax(rng, tmp_path, n):
    # 1 and 3 Gaussians at one point: the voxelizer's width is 0 (C1); the
    # voxel position is 0, as in the JAX package, never INT_MIN
    scene = _scene(rng, n)
    scene["means"][:] = scene["means"][0]
    want = jgv.compress_to_nvox(scene, depth=10)
    got = tgv.compress_to_nvox(scene, depth=10, output_dir=str(tmp_path), device="cpu")
    _check_compressed(got, want)
    assert got.n_voxels == 1 and not got.positions_int.any()
    from raht3dgs_tpu_torch.io.ply import read_compressed_3dgs_ply

    V, _, _, _ = read_compressed_3dgs_ply(tmp_path / "compressed_Nvox_gaussians.ply")
    np.testing.assert_array_equal(V, np.zeros((1, 3)))


def test_compress_gaussian_scene_uniform_weights_matches_jax():
    scene = synth.gaussian_scene(20000, seed=2)
    want = jgv.compress_to_nvox(scene, depth=10, weight_by_opacity=False)
    got = tgv.compress_to_nvox(scene, depth=10, weight_by_opacity=False, device="cpu")
    _check_compressed(got, want)
    assert got.n_voxels < got.n_input


def test_gaussian_scene_layout():
    scene = synth.gaussian_scene(3000, seed=4)
    pts, rgb = synth.raw_surface_cloud(3000, seed=4)
    assert scene["means"].dtype == np.float64
    np.testing.assert_array_equal(scene["means"], pts.astype(np.float64))
    np.testing.assert_allclose(np.linalg.norm(scene["quats"], axis=1), 1.0, rtol=1e-12)
    assert scene["scales"].shape == (3000, 3) and (scene["scales"] > 0).all()
    assert 0.05 <= scene["opacities"].min() and scene["opacities"].max() < 1.0
    assert scene["colors"].shape == (3000, 48)
    np.testing.assert_allclose(scene["colors"][:, :3] * synth.SH_C0 + 0.5, rgb / 255.0,
                               atol=1e-12)
    again = synth.gaussian_scene(3000, seed=4)
    assert all(np.array_equal(scene[k], again[k]) for k in _KEYS)


# -- the 56-channel RD sweep -----------------------------------------------


def _symbols(stream, n):
    out = np.zeros((stream.n_channels, n), np.int32)
    rlgr_decode_channels(stream.channels, n, out=out, chunk=stream.chunk)
    return out


def _tie_mask(V, attrs, depth, bucket, jdt, step_vec):
    jf = jp.prepare_voxel_frame(V, attrs, depth, bucket=bucket, dtype=jdt)
    coeffs, order, _, _ = jp.AttributeCodec(depth, dtype=jdt).transform(jf)
    n = jf.n_voxels
    perm = np.asarray(jp._pads_last(order, jnp.int32(n)))[:n]
    t = np.asarray(coeffs, np.float64)[perm] / step_vec + 0.5
    return (np.abs(t - np.round(t)) <= _TIE_TOL[jdt] * np.maximum(1.0, np.abs(t))).T


@pytest.mark.parametrize("per_attribute", [False, True])
@pytest.mark.parametrize("jdt", [jnp.float64, jnp.float32])
def test_encode_gs_frame_matches_jax(jdt, per_attribute):
    # a JAX CompressedGaussians (numpy) carried into the port's codec
    from raht3dgs_tpu_torch.cli.encode_3dgs import per_attribute_scales

    res = jgv.compress_to_nvox(_scene(np.random.default_rng(3), 1500), depth=5)
    r = slice(0, res.n_voxels)
    V = np.asarray(res.positions_int)[r]
    attrs = np.concatenate([res.quats[r], res.scales[r], res.opacities[r][:, None],
                            res.colors[r]], axis=1)
    scales = per_attribute_scales() if per_attribute else None
    kw = dict(depth=5, steps=(0.01, 0.1), group_step_scales=scales, bucket=512,
              keep_streams=True)
    want = jgc.encode_gs_frame(V, attrs, dtype=jdt, **kw)
    got = tgc.encode_gs_frame(V, attrs, dtype=_TORCH[jdt], device="cpu", **kw)
    assert len(got) == len(want) == 2
    tcodec = tp.AttributeCodec(5, dtype=_TORCH[jdt], device="cpu")
    jcodec = jp.AttributeCodec(5, dtype=jdt)
    tf = tp.prepare_voxel_frame(V, attrs, 5, bucket=512, dtype=_TORCH[jdt], device="cpu")
    jf = jp.prepare_voxel_frame(V, attrs, 5, bucket=512, dtype=jdt)
    n = len(V)
    for a, b in zip(got, want):
        assert (a.frame, a.step, a.n_voxels) == (b.frame, b.step, b.n_voxels)
        assert set(a.psnr) == set(b.psnr) and set(a.times) == set(b.times)
        for k in a.psnr:
            if k.startswith("psnr"):
                assert abs(a.psnr[k] - b.psnr[k]) <= _PSNR_TOL[jdt], k
        ts, js = a.encoded.stream, b.encoded.stream
        np.testing.assert_array_equal(ts.steps, js.steps)
        sa, sb = _symbols(ts, n), _symbols(js, n)
        diff = sa != sb
        if diff.any():
            step_vec = np.broadcast_to(ts.steps, (attrs.shape[1],))
            ties = _tie_mask(V, attrs, 5, 512, jdt, step_vec)
            assert not (diff & ~ties).any()
            assert np.abs(sa - sb)[diff].max() == 1
        else:
            assert ts.to_bytes() == js.to_bytes()
        assert abs(a.bpp - b.bpp) <= 1e-3 * b.bpp
        # CSV rows: equal apart from the time columns (3..14)
        ra, rb = a.csv_row().split(","), b.csv_row().split(",")
        assert len(ra) == len(rb) == 20 and ra[:2] == rb[:2]
        if not diff.any():
            assert ra[2] == rb[2]
        for x, y in zip(ra[15:], rb[15:]):
            assert abs(float(x) - float(y)) <= _PSNR_TOL[jdt] + 1e-6
        assert all(float(x) >= 0.0 for x in ra[3:15])
        # streams cross both ways
        for blob in (ts.to_bytes(), js.to_bytes()):
            rec_t, _ = tcodec.decode(FrameStream.from_bytes(blob), tf.codes, tf.weights)
            rec_j, _ = jcodec.decode(JaxStream.from_bytes(blob), jf.codes, jf.weights)
            assert np.abs(rec_t - np.asarray(rec_j)).max() < _REC_TOL[jdt]
    assert got[0].psnr["psnr_all"] > got[1].psnr["psnr_all"]
    assert got[0].times["RAHT_prelude_time"] == got[1].times["RAHT_prelude_time"] > 0


@pytest.mark.parametrize("impl", ["host", "device"])
def test_encode_gs_frame_predict_matches_jax(impl):
    """The 56-channel sweep with predict: the JAX host encoder's streams
    and CSV rows (the device encoder, run on the CPU, gives its bytes on
    this fixture), and decodes equal across packages."""
    res = jgv.compress_to_nvox(_scene(np.random.default_rng(3), 1500), depth=5)
    r = slice(0, res.n_voxels)
    V = np.asarray(res.positions_int)[r]
    attrs = np.concatenate([res.quats[r], res.scales[r], res.opacities[r][:, None],
                            res.colors[r]], axis=1)
    attrs[:, 8:] += (V @ np.linspace(0.01, 0.05, 3))[:, None]  # smooth colours
    kw = dict(depth=5, steps=(0.01, 0.1), bucket=512, keep_streams=True)
    want = jgc.encode_gs_frame(V, attrs, codec=jp.AttributeCodec(
        5, predict=True, predict_impl="host"), **kw)
    codec = tp.AttributeCodec(5, predict=True, predict_impl=impl, device="cpu")
    got = tgc.encode_gs_frame(V, attrs, codec=codec, **kw)
    tf = tp.prepare_voxel_frame(V, attrs, 5, bucket=512, device="cpu")
    jf = jp.prepare_voxel_frame(V, attrs, 5, bucket=512)
    for a, b in zip(got, want):
        assert a.encoded.stream.predict and a.encoded.stream.predict_mask != 0
        assert a.encoded.stream.to_bytes() == b.encoded.stream.to_bytes()
        ra, rb = a.csv_row().split(","), b.csv_row().split(",")
        assert ra[:3] == rb[:3] and ra[15:] == rb[15:]
        blob = a.encoded.stream.to_bytes()
        rec_t, _ = codec.decode(FrameStream.from_bytes(blob), tf.codes, tf.weights)
        rec_j, _ = jp.AttributeCodec(5).decode(JaxStream.from_bytes(blob), jf.codes,
                                              jf.weights)
        np.testing.assert_array_equal(rec_t, np.asarray(rec_j))


def test_gs_codec_schema_matches_jax():
    assert tgc.CSV_HEADER == jgc.CSV_HEADER
    assert (tgc.DEFAULT_DEPTH, tuple(tgc.DEFAULT_STEPS)) == \
        (jgc.DEFAULT_DEPTH, tuple(jgc.DEFAULT_STEPS))
    psnr = {f"psnr_{k}": 30.0 + i for i, k in
            enumerate(("all", "quats", "scales", "opacity", "colors"))}
    times = {"RAHT_prelude_time": 0.25, "RAHT_transform_time": 1e-3, "Quant_time": 2.0,
             "Entropy_enc_time": 0.5, "Entropy_dec_time": 0.125, "Dequant_time": 1.5,
             "Coeff_reorder_dec_time": 0.5, "iRAHT_time": 3.0}
    args = dict(frame=2, step=0.5, bpp=1.234567891, psnr=psnr, n_voxels=10,
                stream_bytes=7, times=times)
    assert tgc.GsRDPoint(**args).csv_row() == jgc.GsRDPoint(**args).csv_row()
    assert vars(tconf.GsCodecConfig()) == vars(jconf.GsCodecConfig())
    assert vars(tconf.VoxelizeConfig()) == vars(jconf.VoxelizeConfig())


def test_encode_gs_frame_refuses_predict_and_other_device():
    V = np.array([[0, 0, 0], [1, 0, 0]])
    # a predicted codec is no longer refused: it codes the frame (item 13)
    pts = tgc.encode_gs_frame(V, np.ones((2, 56)), depth=3, steps=(0.5,),
                              codec=tp.AttributeCodec(3, predict=True, device="cpu"))
    assert pts[0].encoded is None and pts[0].psnr["psnr_all"] > 0
    codec = tp.AttributeCodec(3, device="cpu")
    codec.device = torch.device("cuda")  # as a CUDA codec would see it
    with pytest.raises(ValueError, match="codec runs on"):
        tgc.encode_gs_frame(V, np.zeros((2, 56)), depth=3, codec=codec, device="cpu")


# -- the quantization study, metrics, constants ------------------------------


def test_quant_analysis_matches_jax(rng):
    coeffs = rng.normal(size=(400, 56)) * np.linspace(0.1, 30, 56)
    coeffs[:, 7] = 2.5  # a constant group: steps floored at 1e-6
    ranges = tqa.coefficient_ranges(coeffs)
    assert ranges == jqa.coefficient_ranges(coeffs)
    assert tqa.strategy_range_normalized(ranges, 200) == \
        jqa.strategy_range_normalized(ranges, 200)
    assert tqa.strategy_importance_weighted(ranges, 900) == \
        jqa.strategy_importance_weighted(ranges, 900)
    s1, (s2, _) = tqa.strategy_range_normalized(ranges), tqa.strategy_importance_weighted(ranges)
    assert tqa.strategy_hybrid(s1, s2, 0.3) == jqa.strategy_hybrid(s1, s2, 0.3)
    assert tqa.quantization_strategy_report(coeffs, 8.0) == \
        jqa.quantization_strategy_report(coeffs, 8.0)
    np.testing.assert_array_equal(tqa.per_group_step_vector(s2), jqa.per_group_step_vector(s2))
    # the rendering ablation: a scene against itself renders equal images
    kw = dict(n_views=2, image_size=32)
    got = tqa.attribute_ablation(coeffs[:, :3], coeffs, coeffs, device="cpu", **kw)
    assert got == jqa.attribute_ablation(coeffs[:, :3], coeffs, coeffs, **kw) == \
        {k: float("inf") for k in jq.GS_ATTRIBUTE_GROUPS}


@pytest.mark.parametrize("kw", [{}, {"level_budget": 300.0},
                                {"coeff_ranges": {"quats": 2.0, "scales": 0.0,
                                                  "opacity": 1.5, "colors": 40.0}}])
def test_importance_allocated_steps_matches_jax(kw):
    np.testing.assert_array_equal(tq.importance_allocated_steps(56, **kw),
                                  jq.importance_allocated_steps(56, **kw))


def test_quantize_constants_and_groups_match_jax():
    assert tq.GS_ATTRIBUTE_GROUPS == jq.GS_ATTRIBUTE_GROUPS
    assert tq.GS_ABLATION_PSNR_DB == jq.GS_ABLATION_PSNR_DB
    for n in (3, 7, 8, 20, 56, 59):
        assert tq.gs_attribute_groups(n) == jq.gs_attribute_groups(n)


def test_metrics_match_jax(rng):
    scene = _scene(rng, 200)
    labels = rng.integers(0, 30, size=200)
    merged = {k: v[:30] for k, v in _scene(rng, 30).items()}
    assert tmet.compute_attribute_metrics(scene, merged, labels) == \
        jmet.compute_attribute_metrics(scene, merged, labels)
    a, b = rng.normal(size=(100, 20)), rng.normal(size=(100, 20))
    assert tmet.gs_group_psnr(a, b) == jmet.gs_group_psnr(a, b)
    assert set(tmet.gs_group_psnr(a, b)) == {"psnr_all", "mse_all", "psnr_quats", "mse_quats",
                                             "psnr_scales", "mse_scales", "psnr_opacity",
                                             "mse_opacity", "psnr_colors", "mse_colors"}
    img = rng.uniform(0, 1, (8, 8, 3))
    assert tmet.image_psnr(img, img * 0.9) == jmet.image_psnr(img, img * 0.9)
    assert tmet.image_psnr(img, img) == float("inf")


# -- the checkpoint loader ---------------------------------------------------


@pytest.mark.parametrize("raw", [True, False])
def test_gsplat_checkpoint_loader_matches_jax(tmp_path, rng, raw):
    n = 50
    splats = {
        "means": torch.tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32),
        "quats": torch.tensor(rng.normal(size=(n, 4)), dtype=torch.float32),
        # raw: training-space logs and logits; else already activated values
        "scales": torch.tensor(np.log(rng.uniform(0.01, 0.05, (n, 3))) if raw
                               else rng.uniform(0.01, 0.05, (n, 3)), dtype=torch.float32),
        "opacities": torch.tensor(rng.normal(size=n) if raw else rng.uniform(0, 1, n),
                                  dtype=torch.float32),
        "sh0": torch.tensor(rng.normal(size=(n, 1, 3)), dtype=torch.float32),
    }
    if raw:
        splats["shN"] = torch.tensor(rng.normal(size=(n, 15, 3)), dtype=torch.float32)
    path = tmp_path / "ckpt.pt"
    torch.save({"splats": splats} if raw else splats, path)
    got, want = tck.load_gsplat_checkpoint(path), jck.load_gsplat_checkpoint(path)
    assert set(got) == set(want) == set(_KEYS)
    for k in _KEYS:
        assert got[k].dtype == np.float64
        np.testing.assert_array_equal(got[k], want[k])
    assert got["colors"].shape == (n, 48 if raw else 3)


def test_gsplat_checkpoint_loader_refuses_bad_files(tmp_path):
    bad = tmp_path / "bad.pt"
    torch.save({"weights": torch.zeros(3)}, bad)
    with pytest.warns(UserWarning, match="could not parse"):
        assert tck.load_gsplat_checkpoint(bad) is None
    (tmp_path / "junk.pt").write_bytes(b"not a checkpoint")
    with pytest.warns(UserWarning):
        assert tck.load_gsplat_checkpoint(tmp_path / "junk.pt") is None


# -- the 3DGS golden fixture -------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gs_golden_stream_hash(dtype):
    # the port's own pins; chip_smoke.py holds the card's float64 stream to them
    pts, attrs = synth.gs_golden_fixture()
    assert pts.shape == (371, 3) and attrs.shape == (371, 56)
    assert np.array_equal(attrs * 1024.0, np.round(attrs * 1024.0))
    dt = getattr(torch, dtype)
    frame = tp.prepare_voxel_frame(pts, attrs, synth.GS_GOLDEN_DEPTH,
                                   bucket=synth.GS_GOLDEN_BUCKET, dtype=dt, device="cpu")
    blob = tp.AttributeCodec(synth.GS_GOLDEN_DEPTH, dtype=dt, device="cpu").encode(
        frame, synth.GS_GOLDEN_STEP).stream.to_bytes()
    assert hashlib.sha256(blob).hexdigest() == synth.GS_GOLDEN_SHA256[dtype]
    # the JAX package decodes it to the port's reconstruction
    jf = jp.prepare_voxel_frame(pts, attrs, synth.GS_GOLDEN_DEPTH,
                                bucket=synth.GS_GOLDEN_BUCKET)
    rec_j, _ = jp.AttributeCodec(synth.GS_GOLDEN_DEPTH).decode(
        JaxStream.from_bytes(blob), jf.codes, jf.weights)
    tf = tp.prepare_voxel_frame(pts, attrs, synth.GS_GOLDEN_DEPTH,
                                bucket=synth.GS_GOLDEN_BUCKET, device="cpu")
    rec_t, _ = tp.AttributeCodec(synth.GS_GOLDEN_DEPTH, device="cpu").decode(
        FrameStream.from_bytes(blob), tf.codes, tf.weights)
    assert np.abs(rec_t - np.asarray(rec_j)).max() < 1e-9
