"""Frames whose metric rows reached the host in the window, over its seconds."""

from benchmark import readers


def read(r):
    return readers.rate(r, "eval")
