"""The port's voxelizer against the JAX package's, on the same numpy cloud.

The port's ``voxelize`` reduces with the shift method; the JAX package's
runs under each of its segment-sum methods (``RAHT3DGS_SEGSUM``), and the
port's ``sorted_segment_sums(method="prefix")`` runs on the voxelizer's own
inputs beside it. Exact: codes, positions, counts, nvox, sort_idx and
point_voxel. The attributes are per-voxel means of segment sums: bitwise
when both sides take the shift method (the JAX association), within 1e-12
(float64) / 1e-6 (float32) of the largest attribute where one side takes
the prefix method. ``delta_pos`` is ``V0s - voxel_size * Vint``, which
XLA:CPU may contract into one fused multiply-add: the two results then
differ by less than half an ulp of the position, so they are held to
``eps(dtype) * width``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cloud
from raht3dgs_tpu.ops import segment as jseg
from raht3dgs_tpu_torch.ops import voxelize as tvox
from raht3dgs_tpu_torch.ops.raht import _code_lanes, _lanes_code
from raht3dgs_tpu_torch.ops.segment import sorted_segment_sums

# the module (``raht3dgs_tpu.ops`` re-exports a function of the same name)
jvox = importlib.import_module("raht3dgs_tpu.ops.voxelize")

EXACT = ("codes", "positions", "counts", "sort_idx", "point_voxel")
_ATTR_TOL = {np.float64: 1e-12, np.float32: 1e-6}


@pytest.fixture(autouse=True)
def _fresh_jit_cache():
    # the JAX package reads its segment-sum method (RAHT3DGS_SEGSUM) at
    # import time and at trace time; no trace of another method may serve a
    # later call, here or in a later test file
    yield
    jax.clear_caches()


def _jax_voxelize(PC, depth, method, monkeypatch, **kw):
    monkeypatch.setattr(jseg, "_SEGSUM_DEFAULT", method)
    jax.clear_caches()
    return jvox.voxelize(jnp.asarray(PC), depth, **kw)


def _segment_inputs(PC, t):
    """The (values, first, extra) that ``voxelize`` hands its segment sums,
    rebuilt from its result (every input row valid)."""
    PC = torch.as_tensor(PC)
    pv = t.point_voxel.long()
    ones = torch.ones(len(pv), 1, dtype=PC.dtype, device=PC.device)
    vals = torch.cat([PC[t.sort_idx.long(), 3:], ones], dim=1)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=pv.device), pv[1:] != pv[:-1]])
    extra = torch.cat([_code_lanes(t.codes[pv], PC.dtype), t.positions[pv].to(PC.dtype)], dim=1)
    return vals, first, extra


def _check_segment_sums(PC, t, method):
    """``sorted_segment_sums`` on the voxelizer's inputs: counts, codes and
    positions exactly the voxelizer's; the shift method's means bitwise,
    the prefix method's within the stated tolerance. Returns the means."""
    D = PC.shape[1] - 3
    sums, extra, _, n_seg = sorted_segment_sums(*_segment_inputs(PC, t), method=method)
    n = int(t.nvox)
    assert int(n_seg) == n
    assert torch.equal(sums[:, D], t.counts)
    assert torch.equal(_lanes_code(extra[:n, :3], t.codes.dtype), t.codes[:n])
    assert torch.equal(extra[:n, 3:].to(t.positions.dtype), t.positions[:n])
    means = sums[:, :D] / torch.clamp_min(sums[:, D], 1.0)[:, None]
    if method == "shift":
        assert torch.equal(means, t.attributes)
    else:
        tol = _ATTR_TOL[np.float32 if means.dtype == torch.float32 else np.float64]
        scale = max(float(t.attributes.abs().max()), 1.0)
        assert float((means - t.attributes).abs().max()) <= tol * scale
    return means


def _check_against_jax(j, t, method):
    n = int(j.nvox)
    assert int(t.nvox) == n and t.nvox.dtype == torch.int32 and t.nvox.dim() == 0
    for f in EXACT:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    dt = np.asarray(j.attributes).dtype.type
    ja, ta = np.asarray(j.attributes), t.attributes.numpy()
    if method == "shift":
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(t.delta_attr.numpy(), np.asarray(j.delta_attr))
    else:
        scale = max(np.abs(ja).max(), 1.0)
        assert np.abs(ta - ja).max() <= _ATTR_TOL[dt] * scale
        assert np.abs(t.delta_attr.numpy() - np.asarray(j.delta_attr)).max() <= \
            2 * _ATTR_TOL[dt] * scale
    width = float(j.width)
    tol = np.finfo(dt).eps * width
    assert np.abs(t.delta_pos.numpy() - np.asarray(j.delta_pos)).max() <= tol
    for f in ("voxel_size", "vmin", "width"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))


@pytest.mark.parametrize("method", ["shift", "prefix"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("depth", [6, 10, 18])
def test_voxelize_matches_jax(rng, monkeypatch, depth, dtype, method):
    PC = make_cloud(rng, 3000, depth, dup_frac=0.5).astype(dtype)
    j = _jax_voxelize(PC, depth, method, monkeypatch)
    t = tvox.voxelize(torch.from_numpy(PC), depth)
    assert int(t.nvox) < 3000  # duplicates merged
    _check_against_jax(j, t, method)
    # the same method of the port's segment sums, on the voxelizer's inputs
    means = _check_segment_sums(PC, t, method)
    if method == "prefix":
        ja = np.asarray(j.attributes)
        scale = max(np.abs(ja).max(), 1.0)
        assert np.abs(means.numpy() - ja).max() <= _ATTR_TOL[ja.dtype.type] * scale


@pytest.mark.parametrize("method", ["shift", "prefix"])
def test_n_valid_padding_matches_jax(rng, monkeypatch, method):
    PC = make_cloud(rng, 256, 5, dup_frac=0.3)
    PCpad = np.concatenate([PC, np.full((64, PC.shape[1]), 1e9)], axis=0)
    j = _jax_voxelize(PCpad, 5, method, monkeypatch, n_valid=jnp.asarray(256))
    t = tvox.voxelize(PCpad, 5, n_valid=256, device="cpu")
    _check_against_jax(j, t, method)
    plain = tvox.voxelize(PC, 5, device="cpu")
    n = int(plain.nvox)
    assert int(t.nvox) == n and not t.counts[n:].any()
    assert torch.equal(t.codes[:n], plain.codes[:n])


def test_vmin_width_overrides_match_jax(rng, monkeypatch):
    PC = make_cloud(rng, 400, 4, dup_frac=0.3)
    vmin, width = np.full(3, -0.25), float(2**4) + 0.5
    j = _jax_voxelize(PC, 4, "shift", monkeypatch, vmin=jnp.asarray(vmin), width=width)
    t = tvox.voxelize(PC, 4, vmin=vmin, width=width, device="cpu")
    _check_against_jax(j, t, "shift")
    t32 = tvox.voxelize(PC.astype(np.float32), 4, vmin=[-0.25] * 3, width=width,
                        device="cpu")
    assert t32.vmin.dtype == torch.float32 and float(t32.width) == width


def test_voxelize_pc_files_byte_identical(rng, tmp_path):
    PC = make_cloud(rng, 300, 4, dup_frac=0.4)
    outs = {}
    for name, fn in (("jax", jvox.voxelize_pc),
                     ("port", lambda pc, p: tvox.voxelize_pc(pc, p, device="cpu"))):
        stem = str(tmp_path / name)
        outs[name] = fn(PC, {"J": 4, "writeFileOut": True, "filename": stem})
        outs[name + "_files"] = [open(f"{stem}{s}", "rb").read()
                                 for s in ("_vox.ply", "_data.txt")]
    for a, b in zip(outs["jax"], outs["port"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
    assert outs["jax_files"] == outs["port_files"]
    with pytest.raises(ValueError, match="filename"):
        tvox.voxelize_pc(PC, {"J": 4, "writeFileOut": True}, device="cpu")


def test_positions_decode_to_codes(rng):
    from raht3dgs_tpu_torch.ops.morton import morton_decode

    for depth in (4, 11):  # int32 and int64 code tiers
        PC = np.concatenate([rng.uniform(0, 100.0, (500, 3)),
                             rng.uniform(0, 255, (500, 2))], axis=1)
        t = tvox.voxelize(PC, depth, device="cpu")
        n = int(t.nvox)
        want = morton_decode(t.codes[:n], depth)
        assert torch.equal(t.positions[:n], want.to(t.positions.dtype))
        assert bool((t.codes[1:] > t.codes[:-1]).all())  # sorted, unique, pads last


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_zero_extent_cloud_matches_jax(rng, monkeypatch, dtype, n):
    # one point, or every point at one position: the width is 0 and the
    # scaled coordinates are NaN, which XLA casts to 0; the port maps NaN
    # to 0 before its integer casts (PyTorch would give INT_MIN)
    PC = np.concatenate([np.tile([1.5, -2.0, 7.25], (n, 1)),
                         rng.uniform(0, 255, (n, 3))], axis=1).astype(dtype)
    j = _jax_voxelize(PC, 6, "shift", monkeypatch)
    t = tvox.voxelize(torch.from_numpy(PC), 6)
    assert int(t.nvox) == int(j.nvox) == 1
    for f in EXACT:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    assert not t.positions.any()
    np.testing.assert_array_equal(t.attributes.numpy(), np.asarray(j.attributes))
    np.testing.assert_array_equal(t.delta_attr.numpy(), np.asarray(j.delta_attr))
    # delta_pos is NaN in both packages (0 / 0 on the grid)
    assert np.isnan(t.delta_pos.numpy()).all() and np.isnan(np.asarray(j.delta_pos)).all()
    for f in ("voxel_size", "vmin", "width"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))


def test_depth21_not_ported():
    with pytest.raises(NotImplementedError, match="item 2"):
        tvox.voxelize(np.zeros((4, 6)), 21, device="cpu")


@pytest.mark.cuda
def test_cuda_voxelize_matches_cpu(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the prefix method launches the scan kernel")
    from raht3dgs_tpu_torch.ops import ds_scan

    PC = torch.from_numpy(make_cloud(rng, 50000, 10, dup_frac=0.5).astype(np.float32))
    g = tvox.voxelize(PC.cuda(), 10)
    c = tvox.voxelize(PC, 10)
    for f in EXACT + ("nvox",):
        assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), f
    assert torch.equal(g.attributes.cpu(), c.attributes)
    assert float((g.delta_pos.cpu() - c.delta_pos).abs().max()) <= \
        np.finfo(np.float32).eps * float(c.width)
    for method in ("shift", "prefix"):
        before = ds_scan.LAUNCHES["ds_cumsum"]
        means = _check_segment_sums(PC.cuda(), g, method)
        torch.cuda.synchronize()
        assert ds_scan.LAUNCHES["ds_cumsum"] - before == (method == "prefix")
        cpu_means = _check_segment_sums(PC, c, method)
        scale = float(c.attributes.abs().max())
        assert float((means.cpu() - cpu_means).abs().max()) <= 1e-6 * scale
