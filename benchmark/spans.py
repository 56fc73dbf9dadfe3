"""The port's spans in a window's readings: `timing["spans"]`, which the
engine's loops fill while they are given `timing`
(`uvhand_tpu_torch/utils/spans.py`), each (name, parent, step, start_ns,
end_ns) in the order the spans opened. The window's loop runs without the
profiler, so these are the host's unprofiled times."""

from __future__ import annotations

import statistics


def median_ms(r, loop: str, name: str):
    """Median over the window's steps of the ms the spans `name` of a step
    took together; None for another loop, or where the window recorded no
    span `name` (a program without spans)."""
    spans = r.timing.get("spans") if r.loop == loop else None
    if not spans:
        return None
    per_step, found = {}, False
    for span_name, _, step, start_ns, end_ns in spans:
        if step is None:
            continue
        per_step.setdefault(step, 0)
        if span_name == name:
            per_step[step] += end_ns - start_ns
            found = True
    return statistics.median(per_step.values()) * 1e-6 if found else None
