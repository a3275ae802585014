"""Bytes the program copies between the host and the card a request, in
MB: its ``h2d_bytes_*`` and ``d2h_bytes_*`` counters over the ``serve``
roots of the profiled units (the geometry decode's round trip, the upload
tiers, codes and weights, the rasterizer's occupancy reads; the image's
fetch is the viewer's own)."""

from portbench import progtrace


def read(record):
    b, s = progtrace.copy_bytes(), progtrace.span("serve")
    return b / 1e6 / s["roots"] if b and s and s["roots"] else None
