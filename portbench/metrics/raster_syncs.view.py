"""The rasterizer's host reads of device values a view (the occupancy
read, one saturation test a blend chunk, the capacity probes): the
program's ``raster_syncs`` counter over its ``raster_views``, over the
profiled units."""

from portbench import progtrace


def read(record):
    s, v = progtrace.counter("raster_syncs"), progtrace.counter("raster_views")
    return s / v if s and v else None
