"""Serving (``models/serving.py``) before the render, in ms a request: the
program's ``geometry``, ``rlgr_decode``, ``upload`` and ``inverse`` spans
(the children of its request root ``serve`` that come before ``render``),
total over their calls, over the ``serve`` roots of the profiled units."""

from portbench import progtrace

CHILDREN = ("geometry", "rlgr_decode", "upload", "inverse")


def read(record):
    root = progtrace.span("serve")
    parts = [progtrace.span(n) for n in CHILDREN]
    if not root or not root["roots"] or not all(parts):
        return None
    return sum(p["total_s"] for p in parts) * 1e3 / root["roots"]
