"""Model FLOPs of the eval window's frames over its seconds, per cent of the peak."""

from benchmark import readers


def read(r):
    return readers.mfu(r, "eval")
