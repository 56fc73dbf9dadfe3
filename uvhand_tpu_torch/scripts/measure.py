"""Timing and roofline helpers shared by the research entry points and
`chip_smoke.py`.

A bound is the least time the card could take for a call: the larger of its
compulsory bytes (each input read once, each output written once) over the
memory rate and its operations over the peak rate for their type. Rates of
one H100 SXM at its full 700 W (NVIDIA's data sheet; dense, no sparsity).
"""

from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # outside the tensor cores
BF16_TC_OPS_PER_S = 989e12  # dense bf16 on the tensor cores


def bound_ms(nbytes, ops, ops_per_s=FP32_OPS_PER_S):
    """(ms, "bytes" or "operations"): whichever of the two limits is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def lower(times):
    """The lower of a kernel's timed turns, leaving out "not measured"
    (None); None if none was measured."""
    seen = [t for t in times if t is not None]
    return min(seen) if seen else None


def us(ms):
    """A time in ms as microseconds for a log line, or "not measured"."""
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


def in_map_corners(shapes, loc) -> int:
    """Bilinear corners of this call's samples that fall inside their map."""
    Ws = torch.tensor([w for _, w in shapes], device=loc.device, dtype=torch.float32)
    Hs = torch.tensor([h for h, _ in shapes], device=loc.device, dtype=torch.float32)
    px = loc[..., 0] * Ws[:, None] - 0.5
    py = loc[..., 1] * Hs[:, None] - 0.5
    corners = 0
    for dy in (0, 1):
        cy = torch.floor(py) + dy
        for dx in (0, 1):
            cx = torch.floor(px) + dx
            corners += int(((cx >= 0) & (cx < Ws[:, None]) & (cy >= 0) & (cy < Hs[:, None])).sum())
    return corners


def msda_bound_ms(value, shapes, loc, attn):
    """Least time for one forward call: compulsory bytes (each input read
    once, the output written once) over HBM bandwidth, or the float32
    operations that this call's in-map corners need over the non-tensor-core
    peak."""
    B, S, M, D = value.shape
    out_bytes = B * loc.shape[1] * M * D * value.element_size()
    # per point: 2 products + 2 subtractions for the pixel coordinates; per
    # in-map corner: 3 for the tent, 2 for the weight, 2 per channel
    ops = loc[..., 0].numel() * 4 + in_map_corners(shapes, loc) * (5 + 2 * D)
    return bound_ms(nbytes(value, loc, attn) + out_bytes, ops)


def msda_bwd_bound_ms(value, shapes, loc, attn, grad, outputs=None):
    """Least time for one backward call: value, locations, attention and the
    incoming gradient read once, the gradients written once (by default
    dvalue / dloc / dattn in the value's, float32 and the attention's types;
    else the tensors `outputs`), or the float32 operations of this call's
    in-map corners."""
    D = value.shape[-1]
    # per point: 4 for the pixel coordinates; per in-map corner: ~12 for the
    # tents, signs, weights and the three per-point sums, and per channel a
    # product and a sum for the dot and a product and an add for dvalue
    ops = loc[..., 0].numel() * 4 + in_map_corners(shapes, loc) * (12 + 4 * D)
    out_bytes = nbytes(value, loc, attn) if outputs is None else nbytes(*outputs)
    return bound_ms(nbytes(value, loc, attn, grad) + out_bytes, ops)


def median_ms(fn, iters=20, warmup=3):
    """Median over `iters` calls of `fn` of the card's time for one call (CUDA
    events around each), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, iters=20, warmup=3):
    """The card's busy time for one call of `fn`: the device time of every
    kernel and copy that `iters` calls launch, as torch.profiler (CUPTI)
    records it, over `iters`, after `warmup` calls; None when the profiler
    saw no device work in three tries (a profile now and then comes back
    without the device's records). Unlike `median_ms` it leaves out
    the host's work between launches, which paces a call of a few
    microseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
        if busy_us > 0:
            return busy_us / 1e3 / iters
    return None
