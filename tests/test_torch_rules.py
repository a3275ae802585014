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


def test_codec_refuses_frame_on_other_device():
    frame = tp.prepare_voxel_frame(np.zeros((1, 3), np.int64), np.zeros((1, 3)),
                                   6, device="cpu")
    codec = tp.AttributeCodec(6, device="cpu")
    codec.device = torch.device("cuda")  # as a CUDA codec would see it
    with pytest.raises(ValueError):
        codec.transform(frame)
