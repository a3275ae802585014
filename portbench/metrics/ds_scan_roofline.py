"""The scan kernel's (``ops/ds_scan.py``, ``csrc/ds_scan.cu``) share of its
roofline over the profiled units, in %: the least time its calls could
take (each call's ``max(bytes / 3.35e12 B/s, 11 n k / 67e12 op/s)``, from
the shapes at the library's boundary, ``devtrace.py``) over the device
time of the ``ds_*`` kernels in the profiler's trace."""


def read(record):
    p = record.get("profile")
    if not p or not p["scan_s"] or not p["scan_bound_s"]:
        return None
    return 100.0 * p["scan_bound_s"] / p["scan_s"]
