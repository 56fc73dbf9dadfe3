"""Host ms a traced train step spent in the engine's `clip+optimizer` range."""

from benchmark import readers


def read(r):
    return readers.stage_ms(r, "train", "clip+optimizer")
