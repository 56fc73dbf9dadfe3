"""Median host ms an eval batch of the window spent in the `decode` span."""

from benchmark import spans


def read(r):
    return spans.median_ms(r, "eval", "decode")
