"""Per cent of the traced train window in which the device ran nothing."""

from benchmark import readers


def read(r):
    return readers.idle(r, "train")
