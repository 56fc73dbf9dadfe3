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


def msda_call_bound_s(B: int, Lq: int, shapes, M: int, D: int, P: int, dtype: str,
                      backward: bool) -> float:
    """Least seconds of one MSDA call (forward, or backward with
    `backward`): value (B, S, M, D), locations (B, Lq, M, L, P, 2) float32,
    attention (B, Lq, M, L, P) and the output (B, Lq, M*D) once each; the
    backward reads the incoming gradient too and writes dvalue, dloc and
    dattn. Operations: per sample point 4 for its pixel coordinates, per
    corner (all four counted: the bound is the bytes' at these shapes either
    way) 5 + 2 D forward, 12 + 4 D backward."""
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    e = TYPE_BYTES[dtype]
    value = B * S * M * D * e
    loc = B * Lq * M * L * P * 2 * 4
    attn = B * Lq * M * L * P * e
    out = B * Lq * M * D * e
    points = B * Lq * M * L * P
    if backward:
        nbytes = value + loc + attn + out + value + loc + attn
        ops = points * 4 + points * 4 * (12 + 4 * D)
    else:
        nbytes = value + loc + attn + out
        ops = points * 4 + points * 4 * (5 + 2 * D)
    peak = PEAK_FLOPS[(dtype, False)]
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def msda_bound_s(config: dict, batch: int, loop: str) -> float:
    """Least seconds of the MSDA calls of one step (`loop` "train": the
    encoder's and the decoder's forwards and their backwards) or one eval
    batch (the forwards), counted from the configuration."""
    m = config["model"]
    shapes = spatial_shapes(config)
    S = sum(h * w for h, w in shapes)
    M, D = m["n_heads"], m["d_model"] // m["n_heads"]
    dt = config["compute_dtype"]
    total = 0.0
    for layers, Lq, P in ((m["num_encoder_layers"], S, m["enc_n_points"]),
                          (m["num_decoder_layers"], m["num_queries"], m["dec_n_points"])):
        total += layers * msda_call_bound_s(batch, Lq, shapes, M, D, P, dt, False)
        if loop == "train":
            total += layers * msda_call_bound_s(batch, Lq, shapes, M, D, P, dt, True)
    return total


def msda_flops(config: dict, batch: int, loop: str) -> float:
    """The MSDA operations of one step or batch (the bound's count)."""
    m = config["model"]
    shapes = spatial_shapes(config)
    S, L = sum(h * w for h, w in shapes), len(shapes)
    M, D = m["n_heads"], m["d_model"] // m["n_heads"]
    total = 0
    for layers, Lq, P in ((m["num_encoder_layers"], S, m["enc_n_points"]),
                          (m["num_decoder_layers"], m["num_queries"], m["dec_n_points"])):
        points = batch * Lq * M * L * P
        total += layers * (points * 4 + points * 4 * (5 + 2 * D))
        if loop == "train":
            total += layers * (points * 4 + points * 4 * (12 + 4 * D))
    return float(total)


def count_flops(config: dict) -> dict:
    """{"train", "eval"}: model FLOPs of one frame. The matrix products and
    convolutions of the plain reference's forward (and, for "train", its
    backward: the gradient of every parameter, nothing recomputed) as
    `torch.utils.flop_counter` counts them at batch 1 on the meta device,
    plus the MSDA calls' operations by `msda_flops`."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.model import UVHandDETR

    res = config["img_res"]
    out = {}
    for loop in ("eval", "train"):
        model = UVHandDETR(backbone=config["backbone"], device="meta", **model_kwargs(config))
        images = torch.zeros(1, res, res, 3, device="meta")
        counter = FlopCounterMode(display=False)
        with counter:
            if loop == "train":
                # dropout and the feature mask are elementwise and draw from
                # a generator, which the meta device has not: the products
                # are those of the eval-mode forward
                outputs = model(images)
                loss = sum(v.sum() for part in ("stacked", "interm_outputs")
                           for v in outputs[part].values())
                loss.backward()
            else:
                with torch.no_grad():
                    model(images)
        out[loop] = float(counter.get_total_flops()) + msda_flops(config, 1, loop)
    return out


def model_kwargs(config: dict) -> dict:
    m = config["model"]
    return {k: m[k] for k in ("num_queries", "d_model", "n_heads", "num_encoder_layers",
                              "num_decoder_layers", "dim_feedforward", "num_feature_levels",
                              "dec_n_points", "enc_n_points", "dropout", "feature_mask_ratio")}
