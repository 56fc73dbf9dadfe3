"""Eval-time tools.

Port of `uvhand_tpu/utils/tools.py::arctic_smoothing` (the reference's
`util/tools.py`), the eval-time `--iter` smoothing.
"""

from __future__ import annotations

import torch


def arctic_smoothing(target, count: int) -> torch.Tensor:
    """(B, T, C) -> iterative pairwise smoothing along T, flattened (B*T, C).

    The reference recursion: for i in 0..T-2, x[i+1] = x[i] = (x[i] + x[i+1]) / 2,
    applied sequentially `count` times; the running average is taken in
    that order (as the JAX package's scan takes it), so the final sequence
    is [a_1, ..., a_{T-1}, a_{T-1}]."""
    x = torch.as_tensor(target)
    B, T, C = x.shape
    for _ in range(count):
        prev, rest = x[:, 0], []
        for t in range(1, T):
            prev = (prev + x[:, t]) / 2.0
            rest.append(prev)
        rest = torch.stack(rest, 1) if rest else x[:, :0]
        x = torch.cat([rest, rest[:, -1:]], 1)[:, :T]
    return x.reshape(-1, C)
