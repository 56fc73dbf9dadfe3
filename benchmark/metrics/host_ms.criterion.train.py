"""Median host ms a train step of the window spent in the `criterion` span."""

from benchmark import spans


def read(r):
    return spans.median_ms(r, "train", "criterion")
