"""Voxels x steps encoded, decoded and scored, in millions, over all the
window's time (the unit in progress at the close included)."""


def read(record):
    if not record["work"]:
        return None
    return record["work"] / record["window_s"] / 1e6
