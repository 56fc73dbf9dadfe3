"""Optimizer parameter groups, gradient clipping, learning-rate schedules
and bfloat16 parameters with stochastic rounding.

Port of `uvhand_tpu/train/state.py` (the reference's
`set_training_scheduler`): AdamW (or SGD with momentum 0.9, `sgd=True`) over
three parameter groups -- general `lr`, backbone `lr_backbone`, and the
sampling-offset / reference-point projections at `lr * lr_linear_proj_mult`
-- with weight decay on every group, the global-norm gradient clip and the
OneCycle / step schedules, all with optax's formulas.

A model whose parameters are bfloat16 (the JAX package's `bf16_params`)
gets `StochasticRounding`: the same torch optimizer over float32 copies and
p <- SR_bf16(f32(p) + update), the JAX package's `float32_optimizer_state`
and `SRTrainState`. Its 16-bit draws come from a torch.Generator seeded
from (seed, step), so a step is repeatable from the two, as in the JAX
package (whose draws come from `fold_in(PRNGKey(seed), step)`; the streams
differ), and a step also takes injected draws.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Sequence

import torch
from torch import nn

GROUPS = ("general", "backbone", "linear_proj")
#: the learned position embedding's names: slot 1 of the reference Joiner
POSITION_EMBEDDING = "backbone.1."


def label_params(
    model: nn.Module,
    backbone_keywords: Sequence[str] = ("backbone",),
    linear_proj_keywords: Sequence[str] = ("sampling_offsets", "reference_points"),
) -> Dict[str, str]:
    """Parameter name -> 'backbone' | 'linear_proj' | 'general', matched on
    the name in that order. Every parameter gets a label, the backbone's
    frozen-BN tensors too, as every leaf does in the JAX package; the Swin's
    and the ConvNeXt's, under `backbone.0.*`, are the backbone's, as the JAX
    package's keyword labels have them (it has no Swin group of its own),
    and so is the AssemblyHands model's ResNet. The
    learned position embedding (`backbone.1.*`, the reference Joiner's slot)
    is 'general', as the JAX package's `pos_embed/*` leaves are."""

    def label(name):
        if name.startswith(POSITION_EMBEDDING):
            return "general"
        if any(k in name for k in backbone_keywords):
            return "backbone"
        if any(k in name for k in linear_proj_keywords):
            return "linear_proj"
        return "general"

    return {name: label(name) for name, _ in model.named_parameters()}


def create_optimizer(model: nn.Module, lr: float = 2e-4, lr_backbone: float = 2e-5,
                     lr_linear_proj_mult: float = 0.1, weight_decay: float = 1e-4,
                     sgd: bool = False, sr_seed: int = 0) -> torch.optim.Optimizer:
    """One parameter group per label, in `GROUPS` order, each group's `lr`
    its base rate (a schedule scales the three together, `scheduled`), with
    weight decay on every group:
      - float32 parameters: AdamW (betas 0.9/0.999, eps 1e-8, decoupled
        decay), or with `sgd` SGD with momentum 0.9 and the decay added to
        the gradient (optax's `add_decayed_weights` then `sgd`);
      - bfloat16 parameters: the same optimizer over float32 copies with
        stochastic rounding (`SRAdamW`, `SRSGD`, their draws seeded by
        `sr_seed`)."""
    labels = label_params(model)
    params = dict(model.named_parameters())
    rates = {"general": lr, "backbone": lr_backbone, "linear_proj": lr * lr_linear_proj_mult}
    groups = [{"params": [params[n] for n in params if labels[n] == g], "lr": rates[g],
               "name": g} for g in GROUPS]
    sgd_args = dict(lr=lr, momentum=0.9, weight_decay=weight_decay)
    adamw_args = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    dtypes = {p.dtype for p in params.values()}
    if torch.bfloat16 in dtypes:
        if dtypes != {torch.bfloat16}:
            raise ValueError(f"parameters of several types {sorted(map(str, dtypes))}: "
                             "bfloat16 parameters must be all of them")
        if sgd:
            return SRSGD(groups, sr_seed=sr_seed, **sgd_args)
        return SRAdamW(groups, sr_seed=sr_seed, **adamw_args)
    if sgd:
        return torch.optim.SGD(groups, **sgd_args)
    return torch.optim.AdamW(groups, **adamw_args)


def stochastic_round_bf16(x: torch.Tensor, bits: torch.Tensor | None = None,
                          generator: torch.Generator | None = None) -> torch.Tensor:
    """float32 -> bfloat16 with stochastic rounding (E[SR(x)] == x): a
    uniform 16-bit draw is added to the low half of the float32 pattern and
    the sum truncated, as `uvhand_tpu/train/state.py::stochastic_round_bf16`
    does. `bits` (any integer type, values in [0, 65536)) are the draws;
    without them they come from `generator`. Given JAX's draws the result
    equals the JAX function's bit for bit. Not NaN-safe, like it."""
    x = x.float()
    if bits is None:
        bits = torch.randint(0, 1 << 16, x.shape, generator=generator, device=x.device,
                             dtype=torch.int32)
    # int32 wraps as optax's uint32 does; 0xFFFF0000 is -65536 as an int32
    xi = (x.view(torch.int32) + bits.to(device=x.device, dtype=torch.int32)) & -65536
    return xi.view(torch.float32).to(torch.bfloat16)


class StochasticRounding:
    """bfloat16 parameters stepped by torch's AdamW or SGD (`SRAdamW`,
    `SRSGD`) over float32 copies of them, with stochastic rounding: each
    step refreshes every copy from f32(p) and gives it p's float32
    gradient, the optimizer steps the copies (so its state is float32), and
    p <- SR_bf16(copy). That is p <- SR_bf16(f32(p) + u), the JAX package's
    `float32_optimizer_state` and `SRTrainState.apply_gradients`.

    `bf16_params` are the model's parameters, in parameter-group order; the
    groups hold the copies. The draws of step t (t updates done before it)
    come from a generator seeded with (sr_seed, t), one draw of each
    parameter's shape in that order; `step(bits=...)` takes them instead.
    The step count and seed live in the parameter groups, so a saved state
    dict resumes them. A parameter sharded over a model axis
    (`train.mesh.shard_state`) takes its rows of the whole parameter's
    draws."""

    def __init__(self, params, *args, sr_seed: int = 0, **kwargs):
        groups = [dict(g) for g in params]
        self.bf16_params = [p for g in groups for p in g["params"]]
        for g in groups:
            g.update(params=[p.detach().float() for p in g["params"]], sr_seed=sr_seed,
                     sr_step=0)
        super().__init__(groups, *args, **kwargs)
        self._draws: torch.Generator | None = None

    def _generator(self, device, seed: int, step: int) -> torch.Generator:
        if self._draws is None:
            self._draws = torch.Generator(device=device)
        # (seed, step) -> one 63-bit seed
        return self._draws.manual_seed((seed * 1_000_003 + step) % (1 << 63))

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Clears the gradients of the bfloat16 parameters (the copies hold
        none between steps)."""
        for p in self.bf16_params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor | None] | None = None,
             bits: Dict[torch.Tensor, torch.Tensor] | None = None):
        """One update. `grads` are the float32 gradients in `bf16_params`
        order (by default their `.grad` widened; None leaves a parameter
        as it is); `bits` maps a parameter to its 16-bit draws (by default
        drawn as the class says)."""
        copies = [c for g in self.param_groups for c in g["params"]]
        if grads is None:
            grads = [None if p.grad is None else p.grad.float() for p in self.bf16_params]
        for p, c, g in zip(self.bf16_params, copies, grads):
            c.copy_(p)
            c.grad = g
        super().step()
        first = self.param_groups[0]
        gen = None if bits is not None else self._generator(copies[0].device, first["sr_seed"],
                                                           first["sr_step"])
        for p, c in zip(self.bf16_params, copies):
            if c.grad is not None:
                b = None if bits is None else bits[p]
                shard = getattr(p, "mp_shard", None)
                if shard is not None and b is None:
                    # a shard takes its rows of the whole parameter's draws,
                    # so every process draws what one process would
                    b = shard.local(torch.randint(0, 1 << 16, shard.whole_shape(c.shape),
                                                  generator=gen, device=c.device,
                                                  dtype=torch.int32))
                p.copy_(stochastic_round_bf16(c, b, gen))
                c.grad = None
        for group in self.param_groups:
            group["sr_step"] += 1


class SRAdamW(StochasticRounding, torch.optim.AdamW):
    """AdamW over bfloat16 parameters with stochastic rounding."""


class SRSGD(StochasticRounding, torch.optim.SGD):
    """SGD over bfloat16 parameters with stochastic rounding."""


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


def global_norm(tensors: Iterable[torch.Tensor], sharded: Sequence[bool] = (),
                group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as a 0-d tensor. The
    tensors flagged in `sharded` are this process's rows of tensors sharded
    over `group` (a model axis): their squares are summed over it, and
    every other tensor, the same on each process of it, counts once."""
    tensors = list(tensors)
    if not any(sharded):
        return torch.nn.utils.get_total_norm(tensors, norm_type=2.0)
    parts = [[t for t, s in zip(tensors, sharded) if s == flag] for flag in (False, True)]
    whole, rows = (torch.nn.utils.get_total_norm(p, norm_type=2.0) ** 2 for p in parts)
    torch.distributed.all_reduce(rows, group=group)
    return torch.sqrt(whole + rows)


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
