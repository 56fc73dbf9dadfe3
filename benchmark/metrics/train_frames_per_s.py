"""Frames of every train step the window completed, over its seconds."""

from benchmark import readers


def read(r):
    return readers.rate(r, "train")
