"""Bytes the program copies between the host and the card (its
``h2d_bytes_*`` and ``d2h_bytes_*`` counters) a decoded frame, in MB: over
the calls of its ``decode`` span that are roots (one a frame the player
asks for), over the profiled units."""

from portbench import progtrace


def read(record):
    b, s = progtrace.copy_bytes(), progtrace.span("decode")
    return b / 1e6 / s["roots"] if b and s and s["roots"] else None
