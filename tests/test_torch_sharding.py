"""The port's device mesh (``parallel/sharding.py``), the mesh batch codec
and ``encode_dataset --batch`` over a mesh, against the port's own
unsharded functions and against the JAX package's mesh programs, on a
virtual 8-slot CPU mesh (``devices=[cpu] * 8``; the JAX package sees 8
CPU devices under ``tests/conftest.py``).

Tolerances: every sharded output is bitwise the port's unsharded output
(the same single-device code runs on each group's frames and channels, and
the scan's columns are independent). Against the JAX package: symbols
under the gate of ROADMAP queue A item 6 (equal except where the JAX
coefficient over the step lies within 1e-5 of a rounding tie, float32);
the roundtrip MSE within rtol 1e-10 of the JAX package's sharded MSE;
float64 streams of non-integer attributes and the CLI's ``.r3ts`` bytes
equal; CSV rates equal and PSNR within 1e-6 dB."""

import csv
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from conftest import unique_voxel_cloud
from raht3dgs_tpu.cli import encode_dataset as jcli
from raht3dgs_tpu.io.ply import save_ply_ascii
from raht3dgs_tpu.models import batch_codec as jbc
from raht3dgs_tpu.parallel import sharding as js
from raht3dgs_tpu_torch.cli import encode_dataset as tcli
from raht3dgs_tpu_torch.io import datasets as tds
from raht3dgs_tpu_torch.models import batch_codec as tbc
from raht3dgs_tpu_torch.parallel import sharding as tsh
from raht3dgs_tpu_torch.utils import device as tdev
from raht3dgs_tpu_torch.utils.synth import morton_codes_np

CPU8 = [torch.device("cpu")] * 8
DEPTH, N, D, BATCH = 5, 512, 8, 8
MESHES = {"dp8": dict(dp=8), "dp4_tp2": dict(dp=4, tp=2), "dp2_sp2_tp2": dict(dp=2, sp=2, tp=2)}
_TORCH = {np.float64: torch.float64, np.float32: torch.float32}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(dtype=np.float64, batch=BATCH, d=D):
    frames = [ge._synthetic_frame(N, DEPTH, d, seed=s) for s in range(batch)]
    return tuple(np.stack([f[i] for f in frames]).astype(dt)
                 for i, dt in ((0, frames[0][0].dtype), (1, dtype), (2, dtype)))


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def test_make_mesh_cases(monkeypatch):
    """``tests/test_sharding.py``'s cases on 8 CPU slots; too few devices and
    no card without ``devices=`` raise."""
    mesh = tsh.make_mesh(8, devices=CPU8)
    assert mesh.shape == {"dp": 8, "sp": 1, "tp": 1}
    assert mesh.axis_names == ("dp", "sp", "tp")
    mesh = tsh.make_mesh(8, dp=4, devices=CPU8)
    assert mesh.shape == {"dp": 4, "sp": 1, "tp": 2}
    assert mesh.devices.shape == (4, 1, 2) and mesh.first == torch.device("cpu")
    mesh = tsh.make_mesh(8, dp=2, sp=2, devices=CPU8)
    assert mesh.shape == {"dp": 2, "sp": 2, "tp": 2}
    assert mesh.axis_devices("sp") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        tsh.make_mesh(8, dp=3, tp=2, devices=CPU8)
    with pytest.raises(ValueError, match="devices="):
        tsh.make_mesh(8, devices=CPU8[:4])
    assert tsh.make_mesh(devices=CPU8[:2]).shape == {"dp": 2, "sp": 1, "tp": 1}
    assert tsh.local_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(tdev, "cuda_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsh.make_mesh(8)


def test_shard_batch_placement_and_refusals():
    """Frames over dp, points over sp, channels over tp, each block on its
    slot; a batch, point count or channel count that does not divide by its
    axis is refused."""
    codes, attrs, weights = _torch(*_batch())
    mesh = tsh.make_mesh(8, dp=2, sp=2, tp=2, devices=CPU8)
    cs, as_, ws = tsh.shard_batch(mesh, codes, attrs, weights)
    assert cs.spec == ("dp", "sp") and as_.spec == ("dp", "sp", "tp")
    assert as_.shape == (BATCH, N, D)
    for (i, j, k), block in as_.blocks.items():
        assert block.shape == (BATCH // 2, N // 2, D // 2)
        assert torch.equal(block, attrs[4 * i:4 * i + 4, 256 * j:256 * j + 256,
                                        4 * k:4 * k + 4])
    assert len(cs.blocks) == 8 and all(b.shape == (4, 256) for b in cs.blocks.values())
    for sharded, full in ((cs, codes), (as_, attrs), (ws, weights)):
        assert torch.equal(sharded.gather(), full)
    with pytest.raises(ValueError, match="dp"):
        tsh.shard_batch(mesh, codes[:3], attrs[:3], weights[:3])
    with pytest.raises(ValueError, match="tp"):
        tsh.shard_batch(mesh, codes, attrs[..., :3], weights)
    with pytest.raises(ValueError, match="sp"):
        tsh.shard_batch(mesh, codes[:, :511], attrs[:, :511], weights[:, :511])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mesh_kw", list(MESHES.values()), ids=list(MESHES))
def test_sharded_equals_unsharded(mesh_kw, dtype):
    """Every batched function on sharded values gives the unsharded output
    bit for bit, assembled on the first device; no point shard is gathered,
    and bytes cross between sp shards exactly when sp > 1."""
    codes, attrs, weights = _torch(*_batch(dtype))
    tdt = _TORCH[dtype]
    nvox = torch.tensor([N - 40 * (b % 3) for b in range(BATCH)], dtype=torch.int32)
    steps = torch.linspace(2.0, 5.0, D, dtype=tdt)
    mesh = tsh.make_mesh(8, devices=CPU8, **mesh_kw)
    tsh.reset_counts()
    cs, as_, ws = tsh.shard_batch(mesh, codes, attrs, weights)
    coeffs, order = tsh.batched_forward(codes, attrs, weights, DEPTH, "ragft", nvox)
    got = tsh.batched_forward(cs, as_, ws, DEPTH, "ragft", nvox)
    assert torch.equal(got[0], coeffs) and torch.equal(got[1], order)
    sc, so = tsh.shard(mesh, coeffs, ("dp", "sp", "tp")), tsh.shard(mesh, order, ("dp", "sp"))
    coeffs_T = tsh.batched_reorder_T(coeffs, order)
    assert torch.equal(tsh.batched_reorder_T(sc, so), coeffs_T)
    sT = tsh.shard(mesh, coeffs_T, ("dp", "tp", "sp"))
    qf = torch.tensor(0.3, dtype=tdt)
    for quant_mode in ("mid", "deadzone"):
        q = tsh.batched_quant_T(coeffs_T, steps, quant_mode, qf)
        assert torch.equal(tsh.batched_quant_T(sT, steps, quant_mode, qf), q)
        assert torch.equal(tsh.batched_quant_reorder(sc, steps, so, quant_mode, qf), q)
    q = tsh.batched_transform_step(codes, attrs, weights, steps, DEPTH, nvox=nvox)
    assert torch.equal(tsh.batched_transform_step(cs, as_, ws, steps, DEPTH, nvox=nvox), q)
    inv = tsh.batched_inverse_order(codes, weights, nvox, DEPTH)
    assert torch.equal(tsh.batched_inverse_order(cs, ws, nvox, DEPTH), inv)
    rec = tsh.batched_decode_step(codes, weights, q, inv, steps, DEPTH, tdt)
    assert torch.equal(tsh.batched_decode_step(cs, ws, q, inv, steps, DEPTH, tdt), rec)
    step = torch.tensor(2.0, dtype=tdt)
    mse = tsh.batched_roundtrip_step(codes, attrs, weights, step, DEPTH)
    assert torch.equal(tsh.batched_roundtrip_step(cs, as_, ws, step, DEPTH), mse)
    assert tsh.COUNTS["sp_gather_bytes"] == 0
    assert (tsh.COUNTS["sp_exchange_bytes"] > 0) == (mesh.shape["sp"] > 1)
    assert tsh.COUNTS["groups"] > 0


def test_transform_step_tp_matches_jax():
    """``batched_transform_step_tp`` on a dp=4 x tp=2 mesh: bitwise the
    port's unsharded step, the JAX package's tp program's symbols under the
    gate, and its ValueErrors with the JAX package's messages."""
    codes, attrs, weights = _batch(np.float32)
    steps = np.full((D,), 4.0, np.float32)
    jmesh = js.make_mesh(8, dp=4, tp=2)
    q_j = np.asarray(js.batched_transform_step_tp(jmesh, jnp.asarray(codes),
                                                  jnp.asarray(attrs), jnp.asarray(weights),
                                                  jnp.asarray(steps), DEPTH))
    tmesh = tsh.make_mesh(8, dp=4, tp=2, devices=CPU8)
    tc, ta, tw = _torch(codes, attrs, weights)
    ts_ = torch.from_numpy(steps)
    q_t = tsh.batched_transform_step_tp(tmesh, tc, ta, tw, ts_, DEPTH)
    assert torch.equal(q_t, tsh.batched_transform_step(tc, ta, tw, ts_, DEPTH))
    assert torch.equal(tsh.batched_transform_step_tp(tmesh, tc, ta, tw, 4.0, DEPTH), q_t)
    diff = q_t.numpy() != q_j
    if diff.any():
        jcoef, jorder = js.batched_forward(jnp.asarray(codes), jnp.asarray(attrs),
                                           jnp.asarray(weights), DEPTH)
        t = np.asarray(js.batched_reorder_T(jcoef, jorder), np.float64) / 4.0 + 0.5
        ties = np.abs(t - np.round(t)) <= 1e-5 * np.maximum(1.0, np.abs(t))
        assert not (diff & ~ties).any(), "symbols differ away from a tie"
    cases = ((dict(dp=2, sp=2, tp=2), steps), (dict(dp=4, tp=2), steps[:3]),
             (dict(dp=4, tp=2), steps.reshape(2, 4)))
    for kw, bad in cases:
        with pytest.raises(ValueError) as ej:
            js.batched_transform_step_tp(js.make_mesh(8, **kw), jnp.asarray(codes),
                                         jnp.asarray(attrs), jnp.asarray(weights),
                                         jnp.asarray(bad), DEPTH)
        with pytest.raises(ValueError) as et:
            tsh.batched_transform_step_tp(tsh.make_mesh(8, devices=CPU8, **kw), tc, ta, tw,
                                          torch.from_numpy(bad), DEPTH)
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("mesh_kw", [dict(dp=4, tp=2), dict(dp=2, sp=2, tp=2)],
                         ids=["dp4_tp2", "dp2_sp2_tp2"])
def test_roundtrip_matches_jax_sharded(mesh_kw):
    """The roundtrip MSE on a mesh within rtol 1e-10 of the JAX package's
    sharded MSE (its psum), and bitwise the port's unsharded MSE."""
    codes, attrs, weights = _batch(np.float64)
    jmesh = js.make_mesh(8, **mesh_kw)
    cs, as_, ws = js.shard_batch(jmesh, codes, attrs, weights)
    with jmesh:
        j_mse = float(js.batched_roundtrip_step(cs, as_, ws, jnp.asarray(2.0), DEPTH))
    tc, ta, tw = _torch(codes, attrs, weights)
    mesh = tsh.make_mesh(8, devices=CPU8, **mesh_kw)
    t_mse = tsh.batched_roundtrip_step(*tsh.shard_batch(mesh, tc, ta, tw),
                                       torch.tensor(2.0, dtype=torch.float64), DEPTH)
    assert abs(float(t_mse) - j_mse) <= 1e-10 * j_mse
    assert torch.equal(t_mse, tsh.batched_roundtrip_step(
        tc, ta, tw, torch.tensor(2.0, dtype=torch.float64), DEPTH))


def _cloud(rng, sizes, d_attr=3):
    pos, attrs = [], []
    for n in sizes:
        p, _, a = unique_voxel_cloud(rng, n, DEPTH, d_attr=d_attr)
        pos.append(p.astype(np.int64))
        attrs.append(a)
    return pos, attrs


@pytest.mark.parametrize("predict", [False, True], ids=["plain", "predict"])
def test_batch_codec_mesh_streams_equal_jax(rng, predict):
    """``BatchAttributeCodec(mesh=)`` on dp=8: every stream byte-equal to
    the JAX package's mesh codec and to the port's codec without a mesh,
    decodes bitwise the unsharded decode."""
    pos, attrs = _cloud(rng, (300, 450, 200, 380, 410, 260, 330, 500))
    jmesh = js.make_mesh(8)
    jf = jbc.prepare_frame_batch(pos, attrs, DEPTH, bucket=512, dtype=jnp.float64)
    jc = jbc.BatchAttributeCodec(DEPTH, dtype=jnp.float64, mesh=jmesh, predict=predict)
    with jmesh:
        jstreams, _ = jc.encode(jf, 2.0)
    tf = tbc.prepare_frame_batch(pos, attrs, DEPTH, bucket=512, dtype=torch.float64,
                                 device="cpu")
    mesh = tsh.make_mesh(8, devices=CPU8)
    tc = tbc.BatchAttributeCodec(DEPTH, dtype=torch.float64, mesh=mesh, predict=predict)
    plain = tbc.BatchAttributeCodec(DEPTH, dtype=torch.float64, device="cpu", predict=predict)
    assert tc.device == torch.device("cpu")
    tstreams, _ = tc.encode(tf, 2.0)
    want = [s.to_bytes() for s in plain.encode(tf, 2.0)[0]]
    assert [s.to_bytes() for s in tstreams] == want == [s.to_bytes() for s in jstreams]
    sweep = tc.encode_sweep(tf, [2.0, 4.0])
    assert [s.to_bytes() for s in sweep[0][0]] == want
    recs, _ = tc.decode(tstreams, tf, inv=None if predict else tc.inverse_order(tf))
    for a, b in zip(recs, plain.decode(tstreams, tf)[0]):
        np.testing.assert_array_equal(a, b)


def _write_tree(root, rng):
    """Frames 1, 2, 4, 5 and 6 of an 8iVFBv2 sequence at J=5 (3 missing)."""
    base = rng.integers(0, 32, (700, 3))
    cols = rng.integers(0, 255, (700, 3))
    for k, fr in enumerate((1, 2, 4, 5, 6)):
        pts = np.clip(base + k, 0, 31)
        _, first = np.unique(morton_codes_np(pts, DEPTH), return_index=True)
        save_ply_ascii(tds.frame_path("8iVFBv2", "loot", fr, str(root)),
                       pts[first].astype(float), cols[first].astype(float), width=31)


def test_encode_dataset_batch_mesh_matches_jax(tmp_path, monkeypatch):
    """``encode_dataset --batch 4`` with 8 CPU slots: the batches pad to the
    mesh (dp=8) and drop the padding; ``.r3ts`` bytes and CSV rows equal the
    JAX CLI's, which sees 8 devices."""
    _write_tree(tmp_path, np.random.default_rng(1))
    monkeypatch.setenv("RAHT3DGS_COMPILE_CACHE", "")
    meshes = []
    real = tsh.make_mesh

    def spy(*a, **kw):
        meshes.append(real(*a, **kw))
        return meshes[-1]

    monkeypatch.setattr(tsh, "local_devices", lambda device=None: CPU8)
    monkeypatch.setattr(tsh, "make_mesh", spy)
    out = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        argv = ["--dataset", "8iVFBv2", "--sequence", "loot", "--data-root", str(tmp_path),
                "--frames", "1", "6", "--steps", "4", "--batch", "4", "--platform", "cpu",
                "--csv", str(tmp_path / f"{name}.csv"), "--save-sequence",
                str(tmp_path / f"{name}.r3ts"), "--code-geometry"]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # frame 3's file is missing
            assert cli.main(argv) == 0
        with open(tmp_path / f"{name}.csv") as f:
            out[name] = list(csv.DictReader(f))
    assert [m.shape for m in meshes] == [{"dp": 8, "sp": 1, "tp": 1}]
    assert [r["Frame"] for r in out["torch"]] == ["1", "2", "4", "5", "6"]
    for a, b in zip(out["torch"], out["jax"], strict=True):
        assert (a["Frame"], a["Quantization_Step"], a["Rate_bpp"]) == \
            (b["Frame"], b["Quantization_Step"], b["Rate_bpp"])
        assert abs(float(a["psnr"]) - float(b["psnr"])) <= 1e-6
    assert (tmp_path / "torch.r3ts").read_bytes() == (tmp_path / "jax.r3ts").read_bytes()
