"""Median host ms an eval batch of the window waited for its batch (the
`wait` span: the loader and the copy's set-up)."""

from benchmark import spans


def read(r):
    return spans.median_ms(r, "eval", "wait")
