"""The yardstick: the H100's peaks, the least time of the MSDA calls a step
makes, and the model FLOPs of a frame.

Peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet; dense, no
sparsity), copied from the port's `scripts/measure.py`. A bound is the
larger of the compulsory bytes (each input read once, each output written
once) over the HBM rate and the operations over the peak of their type.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12
#: FLOP/s by (compute type, TF32): float32 with TF32 off runs outside the
#: tensor cores
PEAK_FLOPS = {("float32", False): 67e12, ("float32", True): 495e12,
              ("bfloat16", False): 989e12, ("bfloat16", True): 989e12}
TYPE_BYTES = {"float32": 4, "bfloat16": 2}
#: the backbones' map strides; one more stride-2 level per extra level
STRIDES = (8, 16, 32)


def peak_flops(config: dict) -> float:
    return PEAK_FLOPS[(config["compute_dtype"], bool(config["tf32"]))]


def spatial_shapes(config: dict) -> List[Tuple[int, int]]:
    """The (H, W) of every level at the configuration's image size: the
    backbone's maps (a conv's ceil) and the extra stride-2 levels."""
    shapes = [(-(-config["img_res"] // s),) * 2 for s in STRIDES]
    side = shapes[-1][0]
    while len(shapes) < config["model"]["num_feature_levels"]:
        side = (side - 1) // 2 + 1  # 3x3, stride 2, padding 1
        shapes.append((side, side))
    return shapes


def msda_call_ops(B: int, Lq: int, L: int, M: int, D: int, P: int, backward: bool) -> int:
    """Operations of one MSDA call: per sample point 4 for its pixel
    coordinates, per corner (all four counted: the bound is the bytes' at
    these shapes either way) 5 + 2 D forward, 12 + 4 D backward."""
    points = B * Lq * M * L * P
    return points * 4 + points * 4 * ((12 + 4 * D) if backward else (5 + 2 * D))


def msda_call_bound_s(B: int, Lq: int, shapes, M: int, D: int, P: int, dtype: str,
                      backward: bool) -> float:
    """Least seconds of one MSDA call (forward, or backward with
    `backward`): value (B, S, M, D), locations (B, Lq, M, L, P, 2) float32,
    attention (B, Lq, M, L, P) and the output (B, Lq, M*D) once each; the
    backward reads the incoming gradient too and writes dvalue, dloc and
    dattn. Operations: `msda_call_ops`."""
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    e = TYPE_BYTES[dtype]
    value = B * S * M * D * e
    loc = B * Lq * M * L * P * 2 * 4
    attn = B * Lq * M * L * P * e
    out = B * Lq * M * D * e
    if backward:
        nbytes = value + loc + attn + out + value + loc + attn
    else:
        nbytes = value + loc + attn + out
    ops = msda_call_ops(B, Lq, L, M, D, P, backward)
    peak = PEAK_FLOPS[(dtype, False)]
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def msda_bound_s(config: dict, batch: int, loop: str, family) -> float:
    """Least seconds of the MSDA calls of one step (`loop` "train") or one
    eval batch, as the configuration's family module lists them
    (`msda_calls`)."""
    m = config["model"]
    shapes = spatial_shapes(config)
    M, D = m["n_heads"], m["d_model"] // m["n_heads"]
    dt = config["compute_dtype"]
    total = 0.0
    for layers, Lq, P, backward in family.msda_calls(config, batch, loop):
        total += layers * msda_call_bound_s(batch, Lq, shapes, M, D, P, dt, backward)
    return total


def msda_flops(config: dict, batch: int, loop: str, family) -> float:
    """The MSDA operations of one step or batch (the bound's count)."""
    m = config["model"]
    L = len(spatial_shapes(config))
    M, D = m["n_heads"], m["d_model"] // m["n_heads"]
    return float(sum(layers * msda_call_ops(batch, Lq, L, M, D, P, backward)
                     for layers, Lq, P, backward in family.msda_calls(config, batch, loop)))


def count_flops(config: dict, family) -> dict:
    """{"train", "eval"}: model FLOPs of one frame. The matrix products and
    convolutions of the family's plain reference (`flops_model`): its
    forward (and, for "train", its backward: the gradient of every
    parameter that an output reaches, nothing recomputed) as
    `torch.utils.flop_counter` counts them at batch 1 on the meta device,
    plus the MSDA calls' operations by `msda_flops`."""
    from torch.utils.flop_counter import FlopCounterMode

    res = config["img_res"]
    out = {}
    for loop in ("eval", "train"):
        model = family.flops_model(config, "meta")
        images = torch.zeros(1, res, res, 3, device="meta")
        counter = FlopCounterMode(display=False)
        with counter:
            if loop == "train":
                # dropout and the feature mask are elementwise and draw from
                # a generator, which the meta device has not: the products
                # are those of the eval-mode forward
                loss = sum(v.sum() for v in tensors(model(images)))
                loss.backward()
            else:
                with torch.no_grad():
                    model(images)
        out[loop] = float(counter.get_total_flops()) + msda_flops(config, 1, loop, family)
    return out


def tensors(outputs) -> list:
    """Every tensor of a model's outputs (nested dicts, lists, tuples)."""
    if isinstance(outputs, torch.Tensor):
        return [outputs]
    if isinstance(outputs, dict):
        outputs = list(outputs.values())
    if isinstance(outputs, (list, tuple)):
        return [t for o in outputs for t in tensors(o)]
    return []
