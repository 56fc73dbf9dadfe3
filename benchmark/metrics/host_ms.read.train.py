"""Median host ms a train step of the window spent in the `read` span: the
loss's read, which waits for the card to finish the step."""

from benchmark import spans


def read(r):
    return spans.median_ms(r, "train", "read")
