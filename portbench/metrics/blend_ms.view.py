"""The rasterizer's front-to-back blend (``eval/rasterize.py``: the band
and chunk loop, its saturation reads and the image's assembly) a view, in
ms: the program's ``blend`` span, total over its calls (one a view), over
the profiled units."""

from portbench import progtrace


def read(record):
    s = progtrace.span("blend")
    return s["total_s"] * 1e3 / s["calls"] if s and s["calls"] else None
