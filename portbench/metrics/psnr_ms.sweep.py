"""Quality scoring (``models/color_codec.py:y_psnr_db``,
``eval/metrics.py:gs_group_psnr``, numpy on the host) a frame-step, in
ms: the program's ``psnr`` span, total over its calls, over the profiled
units."""

from portbench import progtrace


def read(record):
    s = progtrace.span("psnr")
    return s["total_s"] * 1e3 / s["calls"] if s and s["calls"] else None
