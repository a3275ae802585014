"""The 95th percentile of the time to decode one frame, in ms, over every
frame of the window (host clock, each decode ending in its host copy)."""

import numpy as np


def read(record):
    if not record["unit_s"]:
        return None
    return float(np.percentile(np.asarray(record["unit_s"]), 95)) * 1e3
