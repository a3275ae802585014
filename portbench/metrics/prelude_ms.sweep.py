"""Frame preparation (``models/pipeline.py:prepare_voxel_frame``) a frame,
in ms: the benchmark's span around RGB to YUV and ``prepare_frame_batch``
in a batched sweep, the program's ``RAHT_prelude_time`` in a 3DGS sweep."""


def read(record):
    n = record["counts"].get("frames", 0)
    if not n:
        return None
    if "prelude" in record["spans"]:
        return sum(record["spans"]["prelude"]) * 1e3 / n
    if "RAHT_prelude_time" in record["stages"]:
        return record["stages"]["RAHT_prelude_time"] * 1e3 / n
    return None
