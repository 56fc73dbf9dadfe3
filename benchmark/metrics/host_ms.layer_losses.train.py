"""Median host ms a train step of the window spent in the `layer_losses` span."""

from benchmark import spans


def read(r):
    return spans.median_ms(r, "train", "layer_losses")
