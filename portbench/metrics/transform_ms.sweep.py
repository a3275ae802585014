"""The forward transform (``ops/raht_span.py``, the stream order) a frame,
in ms: the program's ``RAHT_transform_time``."""


def read(record):
    n = record["counts"].get("frames", 0)
    if not n or "RAHT_transform_time" not in record["stages"]:
        return None
    return record["stages"]["RAHT_transform_time"] * 1e3 / n
