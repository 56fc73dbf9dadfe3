"""Helpers the metric readers under `metrics/` share. A reader returns
None where its run has nothing for it to read: another loop, or no trace."""

from __future__ import annotations

import numpy as np

from . import roofline
from .trace import MSDA


def rate(r, loop: str):
    """Frames a second over the whole window."""
    if r.loop != loop or r.window_s <= 0 or r.steps == 0:
        return None
    return r.frames / r.window_s


def stage_ms(r, loop: str, stage: str):
    """Host ms a step inside the engine's `stage` range, in the trace."""
    if r.loop != loop or r.trace is None or stage not in r.trace.ranges:
        return None
    return r.trace.ranges[stage] / r.trace.steps * 1e3


def launches(r, loop: str):
    if r.loop != loop or r.trace is None or not r.trace.kernels:
        return None
    return r.trace.launches() / r.trace.steps


def idle(r, loop: str):
    """Per cent of the traced window in which the device ran nothing."""
    if r.loop != loop or r.trace is None or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def msda_roofline(r, loop: str):
    """Per cent: the least time of the traced steps' MSDA calls, counted
    from the configuration by its family's `msda_calls`, over the device
    time of the kernels named `msda_*kernel`."""
    if r.loop != loop or r.trace is None:
        return None
    t = r.trace.kernel_time(MSDA)
    if t <= 0:
        return None
    return 100.0 * roofline.msda_bound_s(r.config, r.batch, loop, r.family) * r.trace.steps / t


def mfu(r, loop: str):
    """Per cent of the peak of the configuration's compute type: the model
    FLOPs of the window's frames over the window's seconds."""
    fps = rate(r, loop)
    if fps is None:
        return None
    return 100.0 * r.config["flops_per_frame"][loop] * fps / roofline.peak_flops(r.config)


def p95(values):
    return float(np.percentile(np.asarray(values, np.float64), 95)) if values else None
