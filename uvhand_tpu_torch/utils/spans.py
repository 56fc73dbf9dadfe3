"""Named spans of the host's work in the loops and steps.

`span(name)` marks a stage of the host's work:
  - while a torch profiler runs, as a `record_function` range, so that a
    profiler trace shows it beside the device work it launched;
  - while this thread records (`recording`), as a `Span` appended to the
    recorder's list in the order the spans open: its name, the index of
    the span it opened inside (None at the top), the loop's step (`steps`)
    and its start and end in ns on the profiler's host clock (the Unix
    epoch's, `time.time_ns`), so that a recorded span lines up with a
    profiler trace of the same moment.
With neither, it costs one check. Spans opened on another thread
(autograd's backward, a loader's workers) are not recorded.

The loops (`engine.train_one_epoch`, `evaluate`, `evaluate_assembly`,
`cli.extract_predicts.run_extraction`) record while they are given a
`timing` dict and leave the spans in `timing["spans"]`.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Iterable, List, NamedTuple, Optional

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function


class Span(NamedTuple):
    name: str
    parent: Optional[int]  # index of the enclosing span in the same list
    step: Optional[int]  # the loop's step or batch index
    start_ns: int
    end_ns: int

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class Recorder:
    """The spans one thread opens, appended to `spans` as they open (a
    span's slot holds None until it closes)."""

    def __init__(self, spans: list):
        self.spans = spans
        self.step: Optional[int] = None
        self.open: List[int] = []  # indices of the open spans, innermost last


_local = threading.local()
_OFF = contextlib.nullcontext()


def _recorder() -> Optional[Recorder]:
    return getattr(_local, "recorder", None)


class _Span:
    __slots__ = ("name", "rec", "range", "index", "parent", "step", "start")

    def __init__(self, name: str, rec: Optional[Recorder]):
        self.name, self.rec = name, rec

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            self.index, self.parent, self.step = len(rec.spans), (rec.open or [None])[-1], rec.step
            rec.spans.append(None)
            rec.open.append(self.index)
            self.start = time.time_ns()
        self.range = record_function(self.name) if _profiler_enabled() else None
        if self.range is not None:
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        rec = self.rec
        if rec is not None:
            rec.spans[self.index] = Span(self.name, self.parent, self.step, self.start,
                                         time.time_ns())
            rec.open.pop()


def span(name: str):
    """A context manager marking the host's stage `name` (module docstring)."""
    rec = _recorder()
    if rec is None and not _profiler_enabled():
        return _OFF
    return _Span(name, rec)


@contextlib.contextmanager
def recording(timing: Optional[dict], **durations: str):
    """While the block runs, record this thread's spans into
    `timing["spans"]`, after any already there, where `timing` is given;
    at the block's end append to `timing[key]` the ms of each span named
    `durations[key]` that it recorded (`wait_ms="wait"`). Without `timing`,
    nothing."""
    if timing is None:
        yield
        return
    spans = timing.setdefault("spans", [])
    first = len(spans)
    outer = _recorder()
    _local.recorder = Recorder(spans)
    try:
        yield
    finally:
        _local.recorder = outer
        for key, name in durations.items():
            timing.setdefault(key, []).extend(s.ms for s in spans[first:] if s.name == name)


_END = object()


def steps(iterable: Iterable, start: int = 0):
    """(i, item) of `iterable`, as `enumerate(iterable, start)` gives them.
    Each item's fetch is a span `wait` of step i, and the spans opened
    until the next fetch belong to step i. The fetch that finds the end is
    not recorded."""
    it = iter(iterable)
    for i in itertools.count(start):
        rec = _recorder()
        if rec is not None:
            rec.step = i
        with span("wait") as s:
            item = next(it, _END)
        if item is _END:
            if rec is not None:
                del rec.spans[s.index:]
            return
        yield i, item
