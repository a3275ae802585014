"""Voxelizer and merge (``models/gs_voxelize.py``, ``ops/segment.py``) a
scene, in ms: the benchmark's span around ``compress_to_nvox``, which
returns host arrays (synced)."""


def read(record):
    t = record["spans"].get("merge")
    return sum(t) * 1e3 / len(t) if t else None
