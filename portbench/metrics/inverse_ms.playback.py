"""The decode half of the transform a frame, in ms: the program's
``Coeff_reorder_dec_time`` + ``Dequant_time`` + ``iRAHT_time`` (structure
pass and inverse order, dequantize, span inverse), mean over the window."""

NAMES = ("Coeff_reorder_dec_time", "Dequant_time", "iRAHT_time")


def read(record):
    n = record["counts"].get("frames", 0)
    s = record["stages"]
    if not n or not all(k in s for k in NAMES):
        return None
    return sum(s[k] for k in NAMES) * 1e3 / n
