"""The port's PLY module against the JAX package's: the same files read to
the same arrays, and the writers give the same bytes, ASCII and binary."""

import numpy as np
import pytest

from raht3dgs_tpu.io import ply as jply
from raht3dgs_tpu_torch.io import ply as tply


def _write_binary(path, pts, rgb):
    """A binary-little-endian PLY (x y z float, red green blue uchar)."""
    rec = np.zeros(len(pts), dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                    ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    for i, c in enumerate("xyz"):
        rec[c] = pts[:, i]
    for i, c in enumerate(("red", "green", "blue")):
        rec[c] = rgb[:, i]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\ncomment width 1023\n"
                + f"element vertex {len(pts)}\n".encode()
                + b"property float x\nproperty float y\nproperty float z\n"
                b"property uchar red\nproperty uchar green\nproperty uchar blue\n"
                b"end_header\n")
        rec.tofile(f)


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_colour_frames_read_alike(rng, tmp_path, fmt):
    pts = rng.uniform(0, 1023, (500, 3))
    rgb = rng.integers(0, 256, (500, 3))
    path = tmp_path / f"f_{fmt}.ply"
    if fmt == "ascii":
        jply.save_ply_ascii(path, pts, rgb, width=1023)
    else:
        _write_binary(path, pts.astype(np.float32), rgb.astype(np.uint8))
    for name in ("read_ply_8i", "read_ply_mvub"):
        _same(getattr(tply, name)(path), getattr(jply, name)(path))
    V, C, J = tply.read_ply_8i(path)
    assert J == 10 and V.shape == (500, 3)
    np.testing.assert_array_equal(C, rgb)
    a, b = tply.read_ply(path), jply.read_ply(path)
    assert a.comments == b.comments
    _same(a.vertices, b.vertices)


@pytest.mark.parametrize("colours,width", [(True, 1023), (False, None)])
def test_ascii_writer_bytes_equal(rng, tmp_path, colours, width):
    pts = rng.uniform(-5, 5, (200, 3))
    rgb = rng.integers(0, 256, (200, 3)) if colours else None
    jply.save_ply_ascii(tmp_path / "j.ply", pts, rgb, width=width)
    tply.save_ply_ascii(tmp_path / "t.ply", pts, rgb, width=width)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()


def test_3dgs_writer_and_readers_agree(rng, tmp_path):
    n = 64
    args = dict(means=rng.normal(size=(n, 3)), quats=rng.normal(size=(n, 4)),
                scales=rng.normal(size=(n, 3)), opacities=rng.uniform(size=n),
                colors=rng.normal(size=(n, 48)), voxel_size=0.25, vmin=np.array([1., 2, 3]))
    jply.save_ply_3dgs(tmp_path / "j.ply", **args)
    tply.save_ply_3dgs(tmp_path / "t.ply", **args)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    for name in ("read_compressed_3dgs_ply", "read_3dgs_scene_ply"):
        _same(getattr(tply, name)(tmp_path / "t.ply"),
              getattr(jply, name)(tmp_path / "j.ply"))


@pytest.mark.parametrize("body", [b"ply\nformat ascii 1.0\n",
                                  b"junk\n",
                                  b"ply\nformat binary_big_endian 1.0\nend_header\n"])
def test_malformed_files_raise_alike(tmp_path, body):
    path = tmp_path / "bad.ply"
    path.write_bytes(body)
    with pytest.raises(ValueError) as je:
        jply.read_ply(path)
    with pytest.raises(ValueError) as te:
        tply.read_ply(path)
    assert str(te.value) == str(je.value)
