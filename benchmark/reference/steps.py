"""The train and eval steps of the plain reference.

The train step: GT preprocessing (no gradient), the model in train mode
(dropout and the feature mask from the given generator), the criterion, the
gradient of every parameter (zero where the loss does not reach it), the
global norm of the raw gradients, optax's clip to `clip_max_norm` and
AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled decay) over three groups:
the backbone at `lr_backbone`, the sampling-offset projections at
`lr * lr_linear_proj_mult`, the rest at `lr`. Written out in plain torch
from the formulas of the port's `engine.make_fused_train_step` and
`train/state.py`; it imports nothing of the port.

The eval step: GT preprocessing, the model in eval mode, the last layer's
selected queries, the decode and the per-frame metrics.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .criterion import arctic_criterion, select_queries
from .evaluation import decode_predictions, measure_error
from .targets import process_targets

TRAIN_KEYS = (
    "images", "intrinsics", "query_idx", "is_valid", "left_valid", "right_valid",
    "mano.pose.r", "mano.pose.l", "mano.beta.r", "mano.beta.l",
    "mano.j3d.full.r", "mano.j3d.full.l", "object.kp3d.full.b",
    "object.kp2d.norm.b", "object.kp2d.norm.t", "object.rot", "object.radian",
    "labels", "keypoints", "target_valid", "joints_valid_r", "joints_valid_l",
    "mano.j2d.norm.r", "mano.j2d.norm.l",
)


def param_rates(model, lr: float, lr_backbone: float, lr_linear_proj_mult: float):
    """Each parameter's learning rate, by name as the port labels them."""
    rates = {}
    for name, _ in model.named_parameters():
        if "backbone" in name:
            rates[name] = lr_backbone
        elif "sampling_offsets" in name or "reference_points" in name:
            rates[name] = lr * lr_linear_proj_mult
        else:
            rates[name] = lr
    return rates


class AdamW:
    """AdamW as torch and optax take it, one parameter at a time."""

    def __init__(self, named_params, rates: Dict[str, float], weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = dict(named_params)
        self.rates, self.wd, self.betas, self.eps = rates, weight_decay, betas, eps
        self.exp_avg = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.exp_avg_sq = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]):
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for n, p in self.params.items():
            g, lr = grads[n], self.rates[n]
            p.mul_(1 - lr * self.wd)
            m = self.exp_avg[n].mul_(b1).add_(g, alpha=1 - b1)
            v = self.exp_avg_sq[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(bc2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-lr / bc1)


def global_norm(tensors) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def train_step(model, mano_r, mano_l, bank, optimizer: AdamW, batch, generator,
               img_res: float, clip_max_norm: float):
    """One update -> (total loss, the clipped gradients by name, the raw
    global norm)."""
    model.train()
    batch = {k: batch[k] for k in TRAIN_KEYS if k in batch}
    with torch.no_grad():
        targets = process_targets(batch, mano_r, mano_l, bank, img_res)
    outputs = model(batch["images"], generator)
    total, _ = arctic_criterion(outputs, targets, mano_r, mano_l, bank, img_res=img_res)
    names = list(optimizer.params)
    raw = torch.autograd.grad(total, [optimizer.params[n] for n in names], allow_unused=True)
    grads = {n: torch.zeros_like(optimizer.params[n]) if g is None else g
             for n, g in zip(names, raw)}
    norm = global_norm(list(grads.values()))
    if clip_max_norm > 0 and float(norm) >= clip_max_norm:
        grads = {n: g / norm * clip_max_norm for n, g in grads.items()}
    optimizer.step(grads)
    return float(total.detach()), grads, float(norm)


@torch.no_grad()
def eval_step(model, mano_r, mano_l, bank, batch, img_res: float) -> Dict[str, torch.Tensor]:
    """-> {metric: (B,) tensor} of one batch."""
    model.eval()
    targets = process_targets(batch, mano_r, mano_l, bank, img_res)
    stacked = model(batch["images"])["stacked"]
    last = {k: v[-1] for k, v in stacked.items() if v is not None}
    pred = decode_predictions(select_queries(last), targets, mano_r, mano_l, bank, img_res)
    return measure_error(pred, targets)
