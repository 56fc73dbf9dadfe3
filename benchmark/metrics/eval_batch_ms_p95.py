"""95th percentile of `engine.evaluate`'s `batch_ms` over every batch of the window."""

from benchmark import readers


def read(r):
    return readers.p95(r.timing.get("batch_ms")) if r.loop == "eval" else None
