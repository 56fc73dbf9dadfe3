"""MSDA calls' least time over their kernels' device time, train steps (per cent)."""

from benchmark import readers


def read(r):
    return readers.msda_roofline(r, "train")
