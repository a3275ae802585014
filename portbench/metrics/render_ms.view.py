"""The rasterizer (``eval/rasterize.py`` through ``parallel/render.py``) a
view, in ms: the program's ``render`` span, total over its calls (one a
view), over the profiled units."""

from portbench import progtrace


def read(record):
    s = progtrace.span("render")
    return s["total_s"] * 1e3 / s["calls"] if s and s["calls"] else None
