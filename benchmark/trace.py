"""The traced segment of a `--trace 1` run, reduced to what the per-layer
readers read.

`traced` runs a callable twice under torch.profiler, first recording the
device's kernels, copies and fills alone (the profiler then slows the host
least), then the host's ops and ranges with them, and reduces the
profiler's events in memory, with no trace file: from the first segment
the device's busy time (the union of its activity intervals), its kernels
by name and the window's length on the host clock; from the second each
host range's total time (the engine's `record_function` stages) and the
longest idle gaps of the device, labelled with the stage the host was in
when the gap began.

Kernel categories are the port's `scripts/profile_step.py`'s, copied: an
MSDA kernel by its name, then GEMM/conv, copies, elementwise/reduction,
other.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

MSDA = re.compile(r"\bmsda_\w*kernel")
CATEGORIES = (
    ("GEMM/conv", re.compile(r"gemm|cutlass|cublas|xmma|conv|wgrad|dgrad|winograd|cudnn|"
                             r"aten::(mm|bmm|addmm|baddbmm|matmul|linear|convolution|_convolution"
                             r"|cudnn_convolution|mkldnn_convolution)\b", re.I)),
    ("copies", re.compile(r"memcpy|memset|copy|aten::(to|_to_copy|contiguous|clone|cat|stack)\b",
                          re.I)),
    ("elementwise/reduction", re.compile(r"elementwise|vectorized|unrolled|reduce|reduction|"
                                         r"softmax|norm|index|scatter|gather|where|aten::", re.I)),
)
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def category(name: str) -> str:
    if MSDA.search(name):
        return "msda"
    for cat, pattern in CATEGORIES:
        if pattern.search(name):
            return cat
    return "other"


@dataclass
class Trace:
    """What one traced segment showed. Times in seconds."""

    steps: int
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)  # name: (count, s)
    ranges: Dict[str, float] = field(default_factory=dict)  # host range: total s
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # longest idle gaps
    kinds: Dict[str, int] = field(default_factory=dict)  # events by activity type

    def kernel_time(self, pattern: re.Pattern) -> float:
        return sum(s for name, (_, s) in self.kernels.items() if pattern.search(name))

    def launches(self) -> int:
        return sum(n for n, _ in self.kernels.values())

    def breakdown(self, top: int = 10) -> dict:
        """The device's top ops by time (category: kernel name) and the
        longest idle gaps by the host stage they began in."""
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        return {"device_ops": [[f"{category(n)}: {n[:120]}", s] for n, (_, s) in ops],
                "idle_gaps": [[name, s] for name, s in self.gaps[:top]]}


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """(total ns covered, the merged intervals in order)."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


def _kind(e) -> str:
    """The event's activity type: kineto's own name where this torch gives
    it, else from its device and its name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    on_device = str(e.device_type()).endswith("CUDA")
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device:
        return "cpu_op"
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def reduce_events(events, steps: int, window_s: float, stages) -> Trace:
    """Reduce kineto events (objects with name(), activity_type(),
    start_ns(), duration_ns()) of a window of `steps` steps."""
    device, kernels = [], defaultdict(lambda: [0, 0.0])
    ranges: Dict[str, float] = Counter()
    host_ranges = []
    kinds: Dict[str, int] = Counter()
    for e in events:
        kind = _kind(e)
        kinds[kind] += 1
        start, dur = e.start_ns(), e.duration_ns()
        if kind in DEVICE_ACTIVITIES:
            device.append((start, start + dur))
            if kind == "kernel":
                k = kernels[e.name()]
                k[0] += 1
                k[1] += dur * 1e-9
        elif kind == "user_annotation" and e.name() in stages:
            ranges[e.name()] += dur * 1e-9
            host_ranges.append((start, start + dur, e.name()))
    busy_ns, merged = _union(device)
    host_ranges.sort()
    starts = [r[0] for r in host_ranges]

    def stage_at(t: int) -> str:
        # the stages follow one another: the last to start before t is the
        # only one that can hold it
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and host_ranges[i][1] > t:
            return host_ranges[i][2]
        return "outside the stages"

    gaps = [(merged[i][1], merged[i + 1][0] - merged[i][1]) for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: -g[1])
    named = [(stage_at(t), d * 1e-9) for t, d in gaps[:10]]
    return Trace(steps, window_s, busy_ns * 1e-9,
                 {n: (c, s) for n, (c, s) in kernels.items()}, dict(ranges), named, dict(kinds))


def capture(run, steps: int, stages, device, host: bool) -> Trace:
    """Run `run()` (which drives `steps` steps and returns once their
    results are on the host) under torch.profiler; its reduced trace. With
    `host` the profiler records the host's ops and ranges as well as the
    device's activity (on the CPU: the host's alone); without, the device's
    activity alone, which slows the host far less."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    sync()
    activities = (([ProfilerActivity.CPU] if host or not cuda else [])
                  + ([ProfilerActivity.CUDA] if cuda else []))
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        window_s = time.perf_counter() - t0
    return reduce_events(prof.profiler.kineto_results.events(), steps, window_s, stages)


def traced(run, steps: int, stages, device) -> Trace:
    """Two traced segments of `steps` steps: the device's activity alone
    (busy time, window, kernels), then the host's too (its ranges, and the
    device's idle gaps labelled by the range the host was in)."""
    device_side = capture(run, steps, stages, device, host=False)
    host_side = capture(run, steps, stages, device, host=True)
    device_side.ranges, device_side.gaps = host_side.ranges, host_side.gaps
    device_side.kinds = {k: device_side.kinds.get(k, 0) + host_side.kinds.get(k, 0)
                         for k in set(device_side.kinds) | set(host_side.kinds)}
    return device_side
