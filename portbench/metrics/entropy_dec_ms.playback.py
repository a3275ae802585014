"""Host entropy decoding (``codec/rlgr.py``, ``native/rlgr.cpp``): the
program's ``Entropy_dec_time`` a frame, mean over the window, in ms."""


def read(record):
    n = record["counts"].get("frames", 0)
    if not n or "Entropy_dec_time" not in record["stages"]:
        return None
    return record["stages"]["Entropy_dec_time"] * 1e3 / n
