"""Host entropy coding (``codec/rlgr.py``, ``native/rlgr.cpp``): the
program's ``Entropy_enc_time`` + ``Entropy_dec_time`` over the window, in
ms a million voxel-steps."""


def read(record):
    s = record["stages"]
    if not record["work"] or "Entropy_enc_time" not in s:
        return None
    return (s["Entropy_enc_time"] + s.get("Entropy_dec_time", 0.0)) * 1e3 \
        / (record["work"] / 1e6)
