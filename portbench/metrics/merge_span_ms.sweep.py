"""Voxelizer and merge (``models/gs_voxelize.py:compress_to_nvox``:
upload, voxelize and merge, download) a scene, in ms: the program's
``merge`` span, total over its calls, over the profiled units."""

from portbench import progtrace


def read(record):
    s = progtrace.span("merge")
    return s["total_s"] * 1e3 / s["calls"] if s and s["calls"] else None
