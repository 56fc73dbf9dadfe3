"""MSDA calls' least time over their kernels' device time, eval batches (per cent)."""

from benchmark import readers


def read(r):
    return readers.msda_roofline(r, "eval")
