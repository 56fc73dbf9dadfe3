"""Host ms a traced train step spent in the engine's `criterion` range."""

from benchmark import readers


def read(r):
    return readers.stage_ms(r, "train", "criterion")
