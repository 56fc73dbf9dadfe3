"""Optimizer parameter groups, gradient clipping and learning-rate schedules.

Port of `uvhand_tpu/train/state.py` (the reference's
`set_training_scheduler`): AdamW over three parameter groups -- general
`lr`, backbone `lr_backbone`, and the sampling-offset / reference-point
projections at `lr * lr_linear_proj_mult` -- with weight decay on every
group, the global-norm gradient clip and the OneCycle / step schedules, all
with optax's formulas. SGD, bfloat16 parameters and stochastic rounding are
not ported.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Sequence

import torch
from torch import nn

GROUPS = ("general", "backbone", "linear_proj")


def label_params(
    model: nn.Module,
    backbone_keywords: Sequence[str] = ("backbone",),
    linear_proj_keywords: Sequence[str] = ("sampling_offsets", "reference_points"),
) -> Dict[str, str]:
    """Parameter name -> 'backbone' | 'linear_proj' | 'general', matched on
    the name in that order. Every parameter gets a label, the backbone's
    frozen-BN tensors too, as every leaf does in the JAX package."""

    def label(name):
        if any(k in name for k in backbone_keywords):
            return "backbone"
        if any(k in name for k in linear_proj_keywords):
            return "linear_proj"
        return "general"

    return {name: label(name) for name, _ in model.named_parameters()}


def create_optimizer(model: nn.Module, lr: float = 2e-4, lr_backbone: float = 2e-5,
                     lr_linear_proj_mult: float = 0.1,
                     weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """AdamW (betas 0.9/0.999, eps 1e-8, decoupled weight decay on every
    group) with one parameter group per label, in `GROUPS` order. Each
    group's `lr` is its base rate; a schedule scales the three together
    (`scheduled`)."""
    labels = label_params(model)
    params = dict(model.named_parameters())
    rates = {"general": lr, "backbone": lr_backbone, "linear_proj": lr * lr_linear_proj_mult}
    groups = [{"params": [params[n] for n in params if labels[n] == g], "lr": rates[g],
               "name": g} for g in GROUPS]
    return torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def scheduled(optimizer: torch.optim.Optimizer, schedule: Callable[[int], float],
              lr: float) -> torch.optim.lr_scheduler.LambdaLR:
    """Scale every group's base rate by schedule(step) / lr, step counting
    updates from 0 as optax's count does; call `.step()` after each
    optimizer step."""
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: schedule(step) / lr)


def set_schedule_step(scheduler: torch.optim.lr_scheduler.LambdaLR, step: int) -> None:
    """Put a `scheduled` schedule at `step`, as after `step` updates (a
    resumed run): each group's rate is its base rate times the schedule's
    factor there, and the next `.step()` moves on to step + 1."""
    scheduler.last_epoch = step
    for group, base, factor in zip(scheduler.optimizer.param_groups, scheduler.base_lrs,
                                   scheduler.lr_lambdas):
        group["lr"] = base * factor(step)
    scheduler._last_lr = [group["lr"] for group in scheduler.optimizer.param_groups]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as a 0-d tensor."""
    return torch.nn.utils.get_total_norm(list(tensors), norm_type=2.0)


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax's `clip_by_global_norm` in place: each g becomes
    (g / norm) * max_norm when norm >= max_norm and is left as it is
    otherwise, decided on the device (no host sync). Not
    `clip_grad_norm_`, which scales by max_norm / (norm + 1e-6)."""
    trigger = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(list(grads), torch.where(trigger, one, norm))
    torch._foreach_mul_(list(grads), torch.where(trigger, one, one * max_norm))


def _cosine_interpolate(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)


def onecycle_schedule(max_lr: float, total_steps: int, pct_start: float = 0.2,
                      div_factor: float = 25.0, final_div_factor: float = 1e4):
    """optax's `cosine_onecycle_schedule` (torch's OneCycleLR with cosine
    annealing) as a function of the step."""
    bounds = (0, int(pct_start * total_steps), int(total_steps))
    init = max_lr / div_factor
    peak = init * div_factor
    values = (init, peak, peak * (1.0 / (div_factor * final_div_factor)))

    def schedule(step: int) -> float:
        for i in range(2):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                return _cosine_interpolate(values[i], values[i + 1], pct)
        return values[-1] if step >= bounds[-1] else 0.0

    return schedule


def step_schedule(lr: float, drop_every_steps: int, gamma: float = 0.1):
    """torch's StepLR (staircase decay) as a function of the step."""
    return lambda step: lr * gamma ** (step // drop_every_steps)
