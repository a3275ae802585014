"""Guards for the port's rules: it imports neither JAX nor the JAX package
(compared as whole top-level module names: ``raht3dgs_tpu_torch`` starts
with the string ``raht3dgs_tpu``), and it never runs on the CPU unless
asked to."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import raht3dgs_tpu_torch
from raht3dgs_tpu_torch.models import pipeline as tp
from raht3dgs_tpu_torch.utils import device as tdev

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "raht3dgs_tpu"}


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(raht3dgs_tpu_torch.__path__,
                                              "raht3dgs_tpu_torch.")
    )


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "raht3dgs_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_every_module_imports_without_jax():
    mods = _port_modules()
    assert "raht3dgs_tpu_torch.ops.ds_scan" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        f"bad = sorted(tops & set({sorted(FORBIDDEN)!r}))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_whole_name_matching_is_not_fooled_by_prefix():
    assert "raht3dgs_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "raht3dgs_tpu.ops".split(".")[0] in FORBIDDEN


def test_entry_points_refuse_silent_cpu(monkeypatch):
    monkeypatch.setattr(tdev, "cuda_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.AttributeCodec(6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.prepare_voxel_frame(np.zeros((1, 3), np.int64), np.zeros((1, 3)), 6)
    with pytest.raises(RuntimeError):
        tdev.resolve_device("cuda")
    assert tp.AttributeCodec(6, device="cpu").device.type == "cpu"
    frame = tp.prepare_voxel_frame(np.zeros((1, 3), np.int64), np.zeros((1, 3)),
                                   6, device="cpu")
    assert frame.codes.device.type == "cpu"
    # ops given host arrays follow the same rule; tensors keep their device
    from raht3dgs_tpu_torch.ops.morton import morton_encode

    with pytest.raises(RuntimeError):
        morton_encode(np.zeros((2, 3), np.int64), 6)
    assert morton_encode(torch.zeros(2, 3, dtype=torch.int64), 6).device.type == "cpu"
    # the voxelizer, the segment sums, the colour codec and both CLIs' default
    # --platform follow it too
    from raht3dgs_tpu_torch.cli import decode, encode_ply
    from raht3dgs_tpu_torch.models.color_codec import encode_color_frame
    from raht3dgs_tpu_torch.ops.segment import sorted_segment_sums
    from raht3dgs_tpu_torch.ops.voxelize import voxelize

    PC = np.random.default_rng(0).uniform(0, 8, (16, 6))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        voxelize(PC, 3)
    assert voxelize(torch.from_numpy(PC), 3).codes.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encode_color_frame(np.zeros((1, 3)), np.zeros((1, 3)), depth=3, steps=(1,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sorted_segment_sums(np.zeros((4, 1), np.float32), np.ones(4, bool))
    assert sorted_segment_sums(torch.zeros(4, 1), torch.ones(4, dtype=torch.bool))[0] \
        .device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encode_ply.main(["--input", "missing.ply"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode.main(["--stream", "missing.r3tc", "--positions", "p.ply",
                     "--output", "o.ply"])
    # the batched codec, its frame batches and the dataset CLI
    from raht3dgs_tpu_torch.cli import encode_dataset
    from raht3dgs_tpu_torch.models.batch_codec import BatchAttributeCodec, prepare_frame_batch

    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchAttributeCodec(6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_frame_batch([np.zeros((1, 3), np.int64)], [np.zeros((1, 3))], 6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encode_dataset.main(["--dataset", "8iVFBv2", "--sequence", "loot"])
    assert BatchAttributeCodec(6, device="cpu").device.type == "cpu"
    frames = prepare_frame_batch([np.zeros((1, 3), np.int64)], [np.zeros((1, 3))], 6,
                                 device="cpu")
    assert frames[0].codes.device.type == "cpu"


def test_codec_refuses_frame_on_other_device():
    frame = tp.prepare_voxel_frame(np.zeros((1, 3), np.int64), np.zeros((1, 3)),
                                   6, device="cpu")
    codec = tp.AttributeCodec(6, device="cpu")
    codec.device = torch.device("cuda")  # as a CUDA codec would see it
    with pytest.raises(ValueError):
        codec.transform(frame)


@pytest.mark.parametrize("a, b, same", [
    ("cuda", "cuda:0", True), ("cuda:0", "cuda", True), ("cuda", "cuda", True),
    ("cuda", "cuda:1", False), ("cuda:1", "cuda:0", False), ("cpu", "cuda", False),
    ("cpu", "cpu", True),
])
def test_same_device_reads_no_index_as_current(monkeypatch, a, b, same):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tdev.same_device(torch.device(a), torch.device(b)) is same


def test_encode_color_frame_refuses_other_device():
    from raht3dgs_tpu_torch.models.color_codec import encode_color_frame

    codec = tp.AttributeCodec(3, device="cpu")
    codec.device = torch.device("cuda")  # as a CUDA codec would see it
    with pytest.raises(ValueError, match="codec runs on"):
        encode_color_frame(np.zeros((1, 3)), np.zeros((1, 3)), depth=3, steps=(1,),
                           codec=codec, device="cpu")
