"""Device kernels a traced train step launched."""

from benchmark import readers


def read(r):
    return readers.launches(r, "train")
