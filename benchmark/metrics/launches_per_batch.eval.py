"""Device kernels a traced eval batch launched."""

from benchmark import readers


def read(r):
    return readers.launches(r, "eval")
