"""PLY point-cloud I/O in plain numpy.

The port's own copy of ``raht3dgs_tpu/io/ply.py`` (the port imports
nothing of the JAX package), byte for byte the same reader and writers:
one header-driven parser for ASCII and binary-little-endian PLY through
numpy structured dtypes, and vectorized writers.

Layouts kept compatible with the reference codec's files:
- 8i/MVUB ASCII frames (x y z r g b, ``comment width`` carries the octree
  depth as ``J = log2(width + 1)``);
- the "compressed 3DGS" binary layout of 62 float32s per vertex
  (xyz, normals, 3 SH-DC, 45 SH-rest, opacity, 3 scales, 4 quats) with
  ``comment voxel_size`` / ``comment vmin`` metadata, attributes repacked as
  [quats(4), scales(3), opacity(1), colors(48)] = 56 channels.
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclass
class PlyData:
    """Parsed PLY: per-element structured arrays plus header comments."""

    elements: Dict[str, np.ndarray] = field(default_factory=dict)
    comments: List[str] = field(default_factory=list)

    @property
    def vertices(self) -> np.ndarray:
        return self.elements["vertex"]

    def comment_value(self, key: str) -> Optional[List[str]]:
        """Tokens following ``key`` in the first matching comment line."""
        for c in self.comments:
            toks = c.split()
            if toks and toks[0] == key:
                return toks[1:]
        return None


def read_ply(path) -> PlyData:
    """Parse an ASCII or binary-little-endian PLY file."""
    with open(path, "rb") as f:
        # ---- header ----
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        comments: List[str] = []
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        while True:
            raw = f.readline()
            if not raw:
                raise ValueError(f"{path}: unterminated PLY header")
            line = raw.decode("ascii", errors="replace").strip()
            if not line:
                continue
            tok = line.split()
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "comment":
                comments.append(line[len("comment "):])
            elif tok[0] == "element":
                elements.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property":
                if tok[1] == "list":
                    raise ValueError(f"{path}: list properties not supported")
                elements[-1][2].append((tok[2], _PLY_TYPES[tok[1]]))
            elif tok[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: unsupported PLY format {fmt!r}")

        out = PlyData(comments=comments)
        for name, count, props in elements:
            dtype = np.dtype([(p, "<" + t) for p, t in props])
            if fmt == "binary_little_endian":
                data = np.fromfile(f, dtype=dtype, count=count)
            else:
                txt = b"".join(f.readline() for _ in range(count))
                flat = np.loadtxt(
                    _io.BytesIO(txt), dtype=np.float64, ndmin=2
                )
                # count == 0 or a truncated body gives loadtxt output of the
                # wrong shape — validate BEFORE column assignment, which
                # would otherwise raise raw Index/broadcast errors
                flat = flat.reshape(-1, len(props)) if flat.size else \
                    np.zeros((0, len(props)))
                if flat.shape[0] != count:
                    raise ValueError(
                        f"{path}: expected {count} '{name}' records, got "
                        f"{flat.shape[0]}"
                    )
                data = np.zeros(count, dtype=dtype)
                for i, (p, t) in enumerate(props):
                    data[p] = flat[:, i].astype(t)
            if len(data) != count:
                raise ValueError(
                    f"{path}: expected {count} '{name}' records, got {len(data)}"
                )
            out.elements[name] = data
        return out


def _columns(v: np.ndarray, names) -> np.ndarray:
    return np.stack([v[n].astype(np.float64) for n in names], axis=1)


def read_ply_8i(path) -> Tuple[np.ndarray, np.ndarray, int]:
    """8iVFBv2 frame: returns (V, C_rgb, J) with J from ``comment width``
    (reference contract: ``data_util.py:51-94``)."""
    ply = read_ply(path)
    v = ply.vertices
    V = _columns(v, ("x", "y", "z"))
    C = _columns(v, ("red", "green", "blue"))
    width_tok = ply.comment_value("width")
    width = int(width_tok[0]) if width_tok else 0
    J = int(np.log2(width + 1)) if width else 0
    return V, C, J


def read_ply_mvub(path) -> Tuple[np.ndarray, np.ndarray]:
    """MVUB frame: returns (V, C_rgb); depth is fixed at J=9 by the dataset."""
    ply = read_ply(path)
    v = ply.vertices
    return _columns(v, ("x", "y", "z")), _columns(v, ("red", "green", "blue"))


def _sh_rest_names():
    return [f"f_rest_{i}" for i in range(45)]


def _gs_vertices(ply):
    """Positions (float) + packed 56-channel attributes of a 3DGS PLY."""
    v = ply.vertices
    fields = set(v.dtype.names)
    pos = _columns(v, ("x", "y", "z"))
    quats = _columns(v, ("rot_0", "rot_1", "rot_2", "rot_3"))
    scales = _columns(v, ("scale_0", "scale_1", "scale_2"))
    opacity = v["opacity"].astype(np.float64)[:, None]
    # SH colors: standard naming is f_dc_0..2 + f_rest_0..44, but the
    # reference *writer* labels all 48 channels f_dc_* (quality_eval.py:81-82)
    # while its reader parses positionally — accept both layouts.
    if "f_rest_0" in fields:
        sh = np.concatenate(
            [_columns(v, ("f_dc_0", "f_dc_1", "f_dc_2")),
             _columns(v, _sh_rest_names())],
            axis=1,
        )
    else:
        dc_names = sorted(
            (n for n in fields if n.startswith("f_dc_")),
            key=lambda s: int(s.rsplit("_", 1)[1]),
        )
        sh = _columns(v, dc_names)
    attrs = np.concatenate([quats, scales, opacity, sh], axis=1)
    return pos, attrs.astype(np.float32)


def read_3dgs_scene_ply(path):
    """Raw 3DGS scene PLY (float world coordinates, e.g. a gsplat export).

    Returns ``(means (N,3) float64, attributes (N,56) float32,
    voxel_metadata)`` where ``voxel_metadata`` is ``(voxel_size, vmin)``
    when the header carries the compressed-PLY comments, else None.
    Positions are NEVER truncated to integers here — use
    :func:`read_compressed_3dgs_ply` for the integer-voxel contract.
    """
    ply = read_ply(path)
    pos, attrs = _gs_vertices(ply)
    vs_tok = ply.comment_value("voxel_size")
    if vs_tok:
        vmin_tok = ply.comment_value("vmin")
        vmin = (
            np.array([float(t) for t in vmin_tok[:3]])
            if vmin_tok
            else np.zeros(3)
        )
        return pos.astype(np.float64), attrs, (float(vs_tok[0]), vmin)
    return pos.astype(np.float64), attrs, None


def read_compressed_3dgs_ply(path):
    """Voxelized-3DGS PLY (reference layout ``data_util.py:272-382``).

    Returns ``(V_int (N,3) int64, attributes (N,56) float32, voxel_size,
    vmin (3,))`` with attributes packed [quats, scales, opacity, SH colors].
    """
    ply = read_ply(path)
    pos, attrs = _gs_vertices(ply)
    V_int = pos.astype(np.int64)
    vs_tok = ply.comment_value("voxel_size")
    voxel_size = float(vs_tok[0]) if vs_tok else 1.0
    vmin_tok = ply.comment_value("vmin")
    vmin = (
        np.array([float(t) for t in vmin_tok[:3]])
        if vmin_tok
        else np.zeros(3)
    )
    return V_int, attrs, voxel_size, vmin


def save_ply_3dgs(
    path,
    means: np.ndarray,
    quats: np.ndarray,
    scales: np.ndarray,
    opacities: np.ndarray,
    colors: np.ndarray,
    voxel_size: Optional[float] = None,
    vmin: Optional[np.ndarray] = None,
) -> None:
    """Binary 3DGS PLY writer, property layout/metadata matching the
    reference reader (``quality_eval.py:18-117`` <-> ``data_util.py:340-348``).

    ``colors`` is (N, C) SH coefficients (C=48 for degree-3).
    """
    means = np.asarray(means, dtype=np.float32)
    quats = np.asarray(quats, dtype=np.float32)
    scales = np.asarray(scales, dtype=np.float32)
    opacities = np.asarray(opacities, dtype=np.float32).reshape(-1)
    colors = np.asarray(colors, dtype=np.float32)
    n, cdim = colors.shape

    # Standard 3DGS naming (f_dc_0..2 + f_rest_*) — the reference's reader is
    # positional, so this stays byte-compatible with it while also matching
    # the wider gsplat ecosystem. (The reference writer's all-f_dc_* naming
    # quirk is accepted by our reader; see read_compressed_3dgs_ply.)
    if cdim >= 3:
        sh_names = [f"f_dc_{i}" for i in range(3)] + [
            f"f_rest_{i}" for i in range(cdim - 3)
        ]
    else:
        sh_names = [f"f_dc_{i}" for i in range(cdim)]
    names = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + sh_names
        + ["opacity", "scale_0", "scale_1", "scale_2"]
        + ["rot_0", "rot_1", "rot_2", "rot_3"]
    )
    rec = np.zeros(n, dtype=np.dtype([(p, "<f4") for p in names]))
    rec["x"], rec["y"], rec["z"] = means[:, 0], means[:, 1], means[:, 2]
    for i, nm in enumerate(sh_names):
        rec[nm] = colors[:, i]
    rec["opacity"] = opacities
    for i in range(3):
        rec[f"scale_{i}"] = scales[:, i]
    for i in range(4):
        rec[f"rot_{i}"] = quats[:, i]

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        if voxel_size is not None:
            f.write(f"comment voxel_size {voxel_size}\n".encode())
        if vmin is not None:
            vm = np.asarray(vmin, dtype=np.float32)
            f.write(f"comment vmin {vm[0]} {vm[1]} {vm[2]}\n".encode())
        f.write(f"element vertex {n}\n".encode())
        for p in names:
            f.write(f"property float {p}\n".encode())
        f.write(b"end_header\n")
        rec.tofile(f)


def save_ply_ascii(
    path,
    V: np.ndarray,
    C: Optional[np.ndarray] = None,
    width: Optional[int] = None,
) -> None:
    """ASCII x/y/z[/r/g/b] writer with the 8i-style ``comment width`` line."""
    V = np.asarray(V)
    n = V.shape[0]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        if width is not None:
            f.write(f"comment width {width}\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if C is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        if C is None:
            np.savetxt(f, V, fmt="%.6f")
        else:
            block = np.concatenate([V, np.asarray(C)], axis=1)
            np.savetxt(f, block, fmt="%.6f %.6f %.6f %d %d %d")
