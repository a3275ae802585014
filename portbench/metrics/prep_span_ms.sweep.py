"""Frame preparation (``models/pipeline.py:prepare_voxel_frame``: the
host sort and the upload) a frame, in ms: the program's ``prelude`` span
over its ``frames_prepared`` counter, over the profiled units."""

from portbench import progtrace


def read(record):
    s, n = progtrace.span("prelude"), progtrace.counter("frames_prepared")
    return s["total_s"] * 1e3 / n if s and n else None
