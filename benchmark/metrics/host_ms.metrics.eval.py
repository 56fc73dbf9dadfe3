"""Median host ms an eval batch of the window spent in the `metrics` span."""

from benchmark import spans


def read(r):
    return spans.median_ms(r, "eval", "metrics")
