"""Weights drawn from the seed on the device, by the configuration's rules.

The configuration's `init` is a list of rules `{"match": <regex>, <kind>:
<arg>}`, tried in order on each parameter's name, the first match wins:
  - `"fill": c`: every element c,
  - `"normal": s`: N(0, s^2),
  - `"lecun": true`: N(0, 1 / fan_in), fan_in the elements of one output
    row (a linear's inputs, a conv's inputs times its kernel),
  - `"offsets": true`: Deformable DETR's sampling-offset bias (head h
    points along the angle 2 pi h / M, L-inf normalised, point p scaled by
    p + 1).
The parameters are taken in the order of their names, and every normal
draw comes from one call of a generator on the device seeded with the
run's seed, so the same names and shapes get the same tensors on either
side: the port's model and the reference's.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Tuple

import numpy as np
import torch


def offset_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


def _rule(name: str, rules) -> dict:
    for r in rules:
        if re.search(r["match"], name):
            return r
    raise ValueError(f"no init rule matches parameter {name!r}")


@torch.no_grad()
def draw(named_shapes: Iterable[Tuple[str, torch.Size]], config: dict, seed: int,
         device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for each (name, shape), from the
    config's `init` rules and `seed`."""
    items = sorted((n, tuple(s)) for n, s in named_shapes)
    rules = config["init"]
    scale = {}
    for name, shape in items:
        r = _rule(name, rules)
        if "normal" in r:
            scale[name] = float(r["normal"])
        elif r.get("lecun"):
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
            scale[name] = 1.0 / math.sqrt(fan_in)
    total = sum(int(np.prod(s)) for n, s in items if n in scale)
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn(total, generator=gen, device=device)
    m = config["model"]
    out, off = {}, 0
    for name, shape in items:
        n = int(np.prod(shape))
        if name in scale:
            out[name] = noise[off: off + n].view(shape) * scale[name]
            off += n
            continue
        r = _rule(name, rules)
        if r.get("offsets"):
            points = m["enc_n_points"] if "encoder" in name else m["dec_n_points"]
            bias = offset_bias(m["n_heads"], m["num_feature_levels"], points)
            out[name] = torch.as_tensor(bias, device=device).view(shape)
        else:
            out[name] = torch.full(shape, float(r["fill"]), device=device)
    return out


@torch.no_grad()
def load(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    """Copy `tensors` into `model`'s parameters of the same names; raises
    if the names or shapes differ."""
    params = dict(model.named_parameters())
    if set(params) != set(tensors):
        missing, extra = sorted(set(tensors) - set(params)), sorted(set(params) - set(tensors))
        raise ValueError(f"parameters differ: not in the model {missing[:5]}, "
                         f"not drawn {extra[:5]}")
    for name, p in params.items():
        p.copy_(tensors[name])


def shapes(model: torch.nn.Module):
    return [(n, p.shape) for n, p in model.named_parameters()]
