"""The serving loop: GT preprocessing -> forward -> query select -> decode ->
per-frame metrics.

Port of `make_eval_step` / `evaluate` of `uvhand_tpu/engine.py` (the
reference's `test_pose`). Eval only; the train step is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from .data.process import process_targets
from .device import resolve_device
from .evaluation.decode import decode_predictions
from .evaluation.metrics import measure_error
from .losses.criterion import select_queries

#: per-batch metrics measure_error computes
BATCH_METRICS = ("aae", "mpjpe.ra", "mrrpe", "success_rate", "cdev")

#: batch keys the eval step reads; the rest (DETR matching targets) stay on the host
EVAL_KEYS = (
    "images", "intrinsics", "query_idx", "is_valid", "left_valid", "right_valid",
    "mano.pose.r", "mano.pose.l", "mano.beta.r", "mano.beta.l",
    "mano.j3d.full.r", "mano.j3d.full.l", "object.kp3d.full.b",
    "object.kp2d.norm.b", "object.kp2d.norm.t", "object.rot", "object.radian",
)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The eval keys of a numpy batch as tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(batch[k]), device=device)
            for k in EVAL_KEYS if k in batch}


def make_eval_step(model, mano_r, mano_l, obj_bank, img_res: float = 224.0,
                   device=None):
    """-> step(batch) -> {metric: (B,) tensor} for a batch of numpy arrays or
    tensors. Runs on `device` (the CUDA card unless `device="cpu"`), where
    the model and the MANO/object tensors must already be."""
    device = resolve_device(device)

    @torch.inference_mode()
    def step(batch):
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
