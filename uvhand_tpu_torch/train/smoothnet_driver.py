"""SmoothNet training: a frozen base model and a temporal smoother.

Port of `uvhand_tpu/train/smoothnet_driver.py` (the reference's
`smoothnet_main`, util/scripts.py:13-70, and `train_smoothnet` /
`test_smoothnet`, engine.py:294-534). A step runs the base DETR over B
windows of T frames flattened to B*T rows in eval mode with no autograd
(its last layer's outputs are constants, as the JAX package's
`stop_gradient` makes them; the MSDA backward is never launched), selects
each frame's queries, injects sparse parameter noise drawn from the
step's generator, smooths them with `ArcticSmoother` in train mode
(dropout from the same generator), decodes them and takes one AdamW step
on the smoother's parameters alone against `smoothnet_loss`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..data.process import process_targets
from ..device import resolve_device
from ..engine import EVAL_KEYS, to_device
from ..evaluation.decode import decode_predictions
from ..evaluation.metrics import measure_error
from ..losses.criterion import select_queries
from ..models.temporal.smoothnet import ArcticSmoother, inject_param_noise, smoothnet_loss


def base_selected(base_model, batch, mano_r, mano_l, obj_bank, img_res):
    """(targets, the base model's last-layer selected queries) of a batch on
    the device, the base model in eval mode, no autograd."""
    with torch.no_grad():
        targets = process_targets(batch, mano_r, mano_l, obj_bank, img_res)
        base_model.eval()
        outputs = base_model(batch["images"])
        last = {k: v[-1] for k, v in outputs["stacked"].items() if v is not None}
        return targets, select_queries(last)


def make_smoothnet_train_step(base_model, smoother: ArcticSmoother, optimizer, mano_r, mano_l,
                              obj_bank, img_res: float = 224.0, noise_p: float = 0.05,
                              generator: Optional[torch.Generator] = None, device=None):
    """-> step(batch) -> loss dict (0-d tensors: `loss/cd`, `acc/h`, `acc/o`,
    `total`) for a window batch (`collate_windows`) of numpy arrays or
    tensors: one `optimizer` update of the smoother. Runs on `device` (the
    CUDA card unless `device="cpu"`), where both models and the MANO/object
    tensors must already be. The noise and the dropout draw from
    `generator` (a fresh one on the device, seeded 0, when none is
    given)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def step(batch):
        batch = to_device(batch, device)
        targets, selected = base_selected(base_model, batch, mano_r, mano_l, obj_bank, img_res)
        selected = inject_param_noise(generator, selected, noise_p)
        smoother.train()
        optimizer.zero_grad(set_to_none=False)
        smoothed = smoother(selected, generator)
        pred = decode_predictions(smoothed, targets, mano_r, mano_l, obj_bank, img_res)
        total, loss_dict = smoothnet_loss(pred, targets)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in loss_dict.items()}

    step.device = device
    return step


def make_smoothnet_eval_step(base_model, smoother: ArcticSmoother, mano_r, mano_l, obj_bank,
                             img_res: float = 224.0, device=None):
    """-> step(batch) -> {metric: (B*T,) tensor}: the per-frame metrics of the
    smoothed predictions of a window batch (no noise, no dropout)."""
    device = resolve_device(device)

    @torch.inference_mode()
    def step(batch):
        batch = to_device(batch, device)
        targets, selected = base_selected(base_model, batch, mano_r, mano_l, obj_bank, img_res)
        smoother.eval()
        pred = decode_predictions(smoother(selected), targets, mano_r, mano_l, obj_bank,
                                  img_res)
        return measure_error(pred, targets)

    step.device = device
    return step


def create_smoother_state(window_size: int, lr: float = 1e-4,
                          generator: Optional[torch.Generator] = None, device=None):
    """-> (ArcticSmoother(window_size) with weights drawn from `generator`
    on `device`, its optimizer): optax's `adamw(lr)` defaults, stated, as
    torch's AdamW defaults differ (betas 0.9 / 0.999, eps 1e-8, weight decay
    1e-4 on every parameter, decoupled)."""
    smoother = ArcticSmoother(window_size, generator=generator, device=resolve_device(device))
    optimizer = torch.optim.AdamW(smoother.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4)
    return smoother, optimizer
