"""The train step and the serving loop.

Port of `uvhand_tpu/engine.py`:
  - train (`make_fused_train_step`, `train_one_epoch`): GT preprocessing ->
    forward in train mode -> criterion -> backward -> global-norm clip ->
    AdamW step, with the NaN-loss guard;
  - serve (`make_eval_step`, `evaluate`, the reference's `test_pose`): GT
    preprocessing -> forward -> query select -> decode -> per-frame metrics.
The disk data path (DataLoader) and multi-card training are not ported.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .data.process import process_targets
from .device import resolve_device
from .evaluation.decode import decode_predictions
from .evaluation.metrics import measure_error
from .losses.criterion import arctic_criterion, select_queries
from .train.state import clip_by_global_norm_, global_norm

#: per-batch metrics measure_error computes
BATCH_METRICS = ("aae", "mpjpe.ra", "mrrpe", "success_rate", "cdev")

#: batch keys the eval step reads; the rest (DETR matching targets) stay on the host
EVAL_KEYS = (
    "images", "intrinsics", "query_idx", "is_valid", "left_valid", "right_valid",
    "mano.pose.r", "mano.pose.l", "mano.beta.r", "mano.beta.l",
    "mano.j3d.full.r", "mano.j3d.full.l", "object.kp3d.full.b",
    "object.kp2d.norm.b", "object.kp2d.norm.t", "object.rot", "object.radian",
)

#: batch keys the train step reads: the eval keys plus the DETR matching
#: targets and the 2D hand GT that `ArcticDataset` emits for the criterion
TRAIN_KEYS = EVAL_KEYS + (
    "labels", "keypoints", "target_valid", "joints_valid_r", "joints_valid_l",
    "mano.j2d.norm.r", "mano.j2d.norm.l",
)

#: profiler ranges of one train step, in order (`targets` only with preprocess)
TRAIN_STAGES = ("targets", "forward", "criterion", "backward", "clip+optimizer")


def to_device(batch: Dict[str, np.ndarray], device, keys=EVAL_KEYS) -> Dict[str, torch.Tensor]:
    """The `keys` of a numpy batch as tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(batch[k]), device=device)
            for k in keys if k in batch}


def make_loss_fn(model, mano_r, mano_l, obj_bank, img_res: float = 224.0, weights=None,
                 cost_class: float = 1.5, cost_keypoint: float = 4.0, preprocess: bool = True):
    """-> loss_fn(batch of tensors, generator) -> (total, loss dict): the
    training objective. The GT preprocessing carries no gradient.
    `preprocess=False` reads processed targets from `batch["targets"]`."""

    def loss_fn(batch, generator):
        if preprocess:
            with torch.no_grad(), record_function("targets"):
                targets = process_targets(batch, mano_r, mano_l, obj_bank, img_res)
        else:
            targets = batch["targets"]
        with record_function("forward"):
            outputs = model(batch["images"], generator=generator)
        with record_function("criterion"):
            return arctic_criterion(outputs, targets, mano_r, mano_l, obj_bank, img_res=img_res,
                                    weights=weights, cost_class=cost_class,
                                    cost_keypoint=cost_keypoint)

    return loss_fn


def make_fused_train_step(model, mano_r, mano_l, obj_bank, optimizer, img_res: float = 224.0,
                          weights=None, cost_class: float = 1.5, cost_keypoint: float = 4.0,
                          clip_max_norm: float = 0.1, preprocess: bool = True,
                          generator: Optional[torch.Generator] = None, device=None):
    """-> step(batch) -> loss dict (0-d tensors, with `grad_norm`) for a
    batch of numpy arrays or tensors: one optimizer update.

    Runs on `device` (the CUDA card unless `device="cpu"`), where the model,
    the MANO/object tensors and the optimizer's parameters must already be.
    Dropout and the feature mask draw from `generator` (a fresh one on the
    device, seeded 0, when none is given). `grad_norm` is the global norm of
    the raw gradients, taken before the clip. Every parameter gets a
    gradient, zero where the loss does not reach it, so AdamW decays all of
    them as optax does. A learning-rate schedule is stepped by the caller
    after each step (`train.state.scheduled`). The stages are profiler
    ranges named in `TRAIN_STAGES`."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    loss_fn = make_loss_fn(model, mano_r, mano_l, obj_bank, img_res=img_res, weights=weights,
                           cost_class=cost_class, cost_keypoint=cost_keypoint,
                           preprocess=preprocess)
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch):
        if preprocess:
            batch = to_device(batch, device, TRAIN_KEYS)
        model.train()
        optimizer.zero_grad(set_to_none=False)
        total, loss_dict = loss_fn(batch, generator)
        with record_function("backward"):
            total.backward()
        with record_function("clip+optimizer"):
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            norm = global_norm(grads)
            if clip_max_norm > 0:
                clip_by_global_norm_(grads, clip_max_norm, norm)
            optimizer.step()
        loss_dict = {k: v.detach() for k, v in loss_dict.items()}
        loss_dict["grad_norm"] = norm
        return loss_dict

    return step


def train_one_epoch(train_step, batches: Iterable, max_steps: Optional[int] = None
                    ) -> Dict[str, float]:
    """Run `train_step` over `batches`; mean loss and grad norm over steps.
    Raises FloatingPointError on a non-finite loss (the NaN guard), which
    reads the loss on the host every step."""
    sums, n = {"loss": 0.0, "grad_norm": 0.0}, 0
    for i, batch in enumerate(batches):
        loss_dict = train_step(batch)
        total = float(loss_dict["total"])
        if not math.isfinite(total):
            raise FloatingPointError(f"Loss is {total}, stopping training (step {i})")
        sums["loss"] += total
        sums["grad_norm"] += float(loss_dict["grad_norm"])
        n += 1
        if max_steps is not None and n >= max_steps:
            break
    return {k: v / max(n, 1) for k, v in sums.items()}


def make_eval_step(model, mano_r, mano_l, obj_bank, img_res: float = 224.0,
                   device=None):
    """-> step(batch) -> {metric: (B,) tensor} for a batch of numpy arrays or
    tensors. Runs on `device` (the CUDA card unless `device="cpu"`), where
    the model and the MANO/object tensors must already be."""
    device = resolve_device(device)

    @torch.inference_mode()
    def step(batch):
        model.eval()
        batch = to_device(batch, device)
        targets = process_targets(batch, mano_r, mano_l, obj_bank, img_res)
        outputs = model(batch["images"])
        last = {k: v[-1] for k, v in outputs["stacked"].items()}
        pred = decode_predictions(select_queries(last), targets, mano_r, mano_l,
                                  obj_bank, img_res)
        return measure_error(pred, targets, BATCH_METRICS)

    return step


def evaluate(eval_step, batches: Iterable[Dict[str, np.ndarray]]) -> Dict[str, float]:
    """Run `eval_step` over `batches`; nanmean of every metric over frames."""
    per_metric: Dict[str, list] = {}
    for batch in batches:
        for k, v in eval_step(batch).items():
            per_metric.setdefault(k, []).append(v.cpu().numpy())
    return {k: float(np.nanmean(np.concatenate(v))) for k, v in per_metric.items()}
