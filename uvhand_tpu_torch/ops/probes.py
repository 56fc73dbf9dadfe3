"""The gather probes: plain versions and dispatch.

Port of the TPU probes `scripts/probe_dynamic_lane_slice.py` (a head's
window of lanes cut at a run-time offset) and `scripts/repro_dynamic_gather.py`
/ `scripts/probe_gather_scale.py` (`take_along_axis` inside a kernel). Their
kernels are `csrc/probe_lane_slice.cu` and `csrc/probe_gather.cu`
(`msda_cuda.lane_slice_cuda`, `msda_cuda.take_along_axis_cuda`). The
dispatchers launch them for CUDA tensors and run the plain versions for CPU
tensors.
"""

from __future__ import annotations

import torch

from . import msda_cuda


def lane_slice_torch(x: torch.Tensor, M: int, W: int) -> torch.Tensor:
    """out[m * Q + q, w] = 2 * x[q, m * W + w] for x (Q, M * W) -> (M * Q, W)."""
    Q = x.shape[0]
    return (x.view(Q, M, W).transpose(0, 1) * 2.0).reshape(M * Q, W)


def take_along_axis_torch(v: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """numpy's `take_along_axis` (idx of v's shape, int32 or int64)."""
    return torch.take_along_dim(v, idx.long(), dim=axis)


def lane_slice(x, M, W):
    if x.is_cuda:
        return msda_cuda.lane_slice_cuda(x, M, W)
    return lane_slice_torch(x, M, W)


def take_along_axis(v, idx, axis):
    if v.is_cuda:
        return msda_cuda.take_along_axis_cuda(v, idx, axis)
    return take_along_axis_torch(v, idx, axis)
