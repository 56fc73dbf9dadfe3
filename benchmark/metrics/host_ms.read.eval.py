"""Median host ms an eval batch of the window spent in the `read` span: the
rows' read, which waits for the card to finish the batch."""

from benchmark import spans


def read(r):
    return spans.median_ms(r, "eval", "read")
