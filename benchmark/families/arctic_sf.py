"""The `arctic_sf` family: UVHand's arctic_sf model (two-stage Deformable
DETR with 42-d keypoint references and box refinement, on the R50 or
Swin-L backbone), its fused train step (`engine.make_fused_train_step`,
AdamW) and eval step (`engine.make_eval_step`) in the port, the plain
reference's model and steps (`reference/model.py`, `reference/steps.py`),
and the batches of a synthetic ARCTIC root read by the port's data path
(`traffic.py`) with their plain reading (`check.data_numbers`).
The interface: `families/__init__.py`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark import check, roofline, traffic, weights
from benchmark.reference import assets


def dropout_seed(seed: int) -> int:
    return seed + 1


def model_kwargs(config: dict) -> dict:
    m = config["model"]
    return {k: m[k] for k in ("num_queries", "d_model", "n_heads", "num_encoder_layers",
                              "num_decoder_layers", "dim_feedforward", "num_feature_levels",
                              "dec_n_points", "enc_n_points", "dropout", "feature_mask_ratio")}


def port_model(config: dict, device):
    """The port's model of the configuration, in eval mode, its weights
    the seed's (loaded by the caller)."""
    from uvhand_tpu_torch.models.detr import UVHandDETR

    m = config["model"]
    return UVHandDETR(num_queries=m["num_queries"], d_model=m["d_model"], n_heads=m["n_heads"],
                      num_encoder_layers=m["num_encoder_layers"],
                      num_decoder_layers=m["num_decoder_layers"],
                      dim_feedforward=m["dim_feedforward"],
                      num_feature_levels=m["num_feature_levels"],
                      dec_n_points=m["dec_n_points"], enc_n_points=m["enc_n_points"],
                      dropout=m["dropout"], feature_mask_ratio=m["feature_mask_ratio"],
                      two_stage=config["two_stage"], with_box_refine=config["with_box_refine"],
                      compute_dtype=getattr(torch, config["compute_dtype"]),
                      backbone=config["backbone"], generator=torch.Generator().manual_seed(0),
                      device=device)


def port(config: dict, world, device, seed: int, loop: str):
    """(the port's model with the seed's weights, its fused train step over
    AdamW or its eval step, the optimizer or None)."""
    from uvhand_tpu_torch import engine
    from uvhand_tpu_torch.geometry.mano import MANOModel
    from uvhand_tpu_torch.geometry.objects import ObjectBank
    from uvhand_tpu_torch.train.state import create_optimizer

    world_ = world(MANOModel, ObjectBank, device)
    model = port_model(config, device)
    weights.load(model, weights.draw(weights.shapes(model), config, seed, device))
    img_res = float(config["img_res"])
    if loop != "train":
        return model, engine.make_eval_step(model, *world_, img_res=img_res, device=device), None
    o = config["optimizer"]
    optimizer = create_optimizer(model, lr=o["lr"], lr_backbone=o["lr_backbone"],
                                 lr_linear_proj_mult=o["lr_linear_proj_mult"],
                                 weight_decay=o["weight_decay"])
    step = engine.make_fused_train_step(
        model, *world_, optimizer, img_res=img_res, clip_max_norm=o["clip_max_norm"],
        generator=torch.Generator(device=device).manual_seed(dropout_seed(seed)), device=device)
    return model, step, optimizer


def flops_model(config: dict, device):
    """The plain reference's model of the configuration, its weights not
    drawn."""
    from benchmark.reference.model import UVHandDETR

    return UVHandDETR(backbone=config["backbone"], device=device, **model_kwargs(config))


def reference_model(config: dict, world, seed: int, device):
    """(the reference's model with the seed's weights, its MANO layers and
    object bank, the weights)."""
    from benchmark.reference.geometry import MANOModel, ObjectBank

    model = flops_model(config, device)
    start = weights.draw(weights.shapes(model), config, seed, device)
    weights.load(model, start)
    return model, world(MANOModel, ObjectBank, device), start


def device_batch(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}


def reference_train(config: dict, world, device, seed: int, batches, check_steps: int) -> dict:
    """The reference's first `check_steps` steps from the same weights,
    inputs and dropout draws."""
    from benchmark.reference import steps as ref_steps

    o = config["optimizer"]
    model, world_, start = reference_model(config, world, seed, device)
    rates = ref_steps.param_rates(model, o["lr"], o["lr_backbone"], o["lr_linear_proj_mult"])
    opt = ref_steps.AdamW(model.named_parameters(), rates, o["weight_decay"])
    gen = torch.Generator(device=device).manual_seed(dropout_seed(seed))
    losses, grad, update1 = [], None, None
    for k in range(check_steps):
        loss, grads, _ = ref_steps.train_step(model, *world_, opt, device_batch(batches[k], device),
                                              gen, float(config["img_res"]), o["clip_max_norm"])
        losses.append(loss)
        if k == 0:
            grad = check.leaf_norms(grads)
            update1 = check.leaf_norms({n: p.detach() - start[n]
                                        for n, p in model.named_parameters()})
        del grads
    update = check.leaf_norms({n: p.detach() - start[n] for n, p in model.named_parameters()})
    return {"losses": losses, "grad": grad, "update1": update1, "update": update}


def reference_eval(config: dict, world, device, seed: int, batches, ids) -> Dict[int, dict]:
    """The reference's rows of the set-up batches `ids`."""
    from benchmark.reference import steps as ref_steps

    model, world_, _ = reference_model(config, world, seed, device)
    out = {}
    for i in sorted(set(ids)):
        rows = ref_steps.eval_step(model, *world_, device_batch(batches[i], device),
                                   float(config["img_res"]))
        out[i] = {k: v.cpu().numpy() for k, v in rows.items()}
    return out


def msda_calls(config: dict, batch: int, loop: str) -> list:
    """The encoder's calls (Lq = S, every position of the levels) and the
    decoder's (Lq = `num_queries`), each layer's forward and, in a train
    step, its backward."""
    m = config["model"]
    S = sum(h * w for h, w in roofline.spatial_shapes(config))
    calls = []
    for layers, Lq, P in ((m["num_encoder_layers"], S, m["enc_n_points"]),
                          (m["num_decoder_layers"], m["num_queries"], m["dec_n_points"])):
        calls.append((layers, Lq, P, False))
        if loop == "train":
            calls.append((layers, Lq, P, True))
    return calls


def make_batches(config: dict, t: dict, seed: int, path: str) -> list:
    """A synthetic ARCTIC root written under `path`, read by the port's
    data path."""
    bank_arrays = assets.synthetic_object_bank()
    traffic.make_root(path, t, bank_arrays, seed)
    return traffic.make_batches(path, t, bank_arrays, config["img_res"], seed)


def check_batches(batches: list, t: dict, config: dict) -> None:
    traffic.check_batches(batches, t, config["img_res"])


def data_numbers(batches: list, path: str, config: dict, t: dict, seed: int) -> Dict[str, float]:
    """The set-up's batches against a plain reading of the root under
    `path`."""
    return check.data_numbers(batches, path, t["split"], config["img_res"], seed)
