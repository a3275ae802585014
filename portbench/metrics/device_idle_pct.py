"""The device's idle share over the profiled units, in %: 100 less the
union of its kernel, copy and memset intervals over the stretch's length
(host clock from the profiler's start to its stop)."""


def read(record):
    p = record.get("profile")
    if not p or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
