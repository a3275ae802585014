"""Bytes the program copies between the host and the card (its
``h2d_bytes_*`` and ``d2h_bytes_*`` counters, pinned and pageable; the
benchmark's own copies are not among them) in MB a million voxel-steps
(its ``voxel_steps`` counter), over the profiled units."""

from portbench import progtrace


def read(record):
    b, n = progtrace.copy_bytes(), progtrace.counter("voxel_steps")
    return b / n if b and n else None
