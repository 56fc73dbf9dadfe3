"""The train step and the serving loop.

Port of `uvhand_tpu/engine.py`:
  - train (`make_fused_train_step`, `train_one_epoch`): GT preprocessing ->
    forward in train mode -> criterion -> backward -> global-norm clip ->
    AdamW step, with the NaN-loss guard;
  - serve (`make_eval_step`, `evaluate`, the reference's `test_pose`): GT
    preprocessing -> forward -> query select -> decode -> (optional
    `--iter` smoothing) -> per-frame metrics;
  - sequence metrics (`make_sequence_eval_step`, `evaluate_sequences`): ACC
    and MDev over each (subject, sequence, view) in time order.
The loops take a `data.loader.DataLoader` (batches copied to the card by
`device_prefetch`) or any iterable of in-memory batches. Multi-card
training is not ported (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import math
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .data.arctic import collate
from .data.loader import device_prefetch, prefetch_samples
from .data.process import process_targets
from .device import resolve_device
from .evaluation.decode import decode_predictions
from .evaluation.mdev import eval_motion_deviation
from .evaluation.metrics import eval_acc_pose, measure_error
from .losses.criterion import arctic_criterion, select_queries
from .train.state import clip_by_global_norm_, global_norm
from .utils.logging import MetricLogger
from .utils.tools import arctic_smoothing

#: per-batch metrics measure_error computes; the sequence metrics (mdev,
#: acc_err_pose) come from `evaluate_sequences`
BATCH_METRICS = ("aae", "mpjpe.ra", "mrrpe", "success_rate", "cdev")

#: what the sequence eval step keeps of the decoded predictions and targets
SEQ_PRED_KEYS = ("mano.v3d.cam.r", "mano.v3d.cam.l", "mano.j3d.cam.r", "mano.j3d.cam.l",
                 "object.v.cam", "object.radian")
SEQ_TARGET_KEYS = SEQ_PRED_KEYS[:5] + (
    "object.parts_ids", "object.radian", "is_valid", "left_valid", "right_valid",
    "dist.ro", "dist.lo", "idx.ro", "idx.lo")

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
    """The `keys` of a batch of numpy arrays or tensors as tensors on
    `device` (a tensor already there is taken as it is)."""
    return {k: batch[k].to(device) if isinstance(batch[k], torch.Tensor)
            else torch.as_tensor(np.asarray(batch[k]), device=device)
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

    step.device = device
    return step


def _batches(step, loader):
    """The batches of `loader` as the loops feed them to `step`: copied to
    the step's device ahead of it (`device_prefetch`) when the step says
    where it runs, else as they come."""
    device = getattr(step, "device", None)
    return iter(loader) if device is None else device_prefetch(loader, device)


def train_one_epoch(train_step, loader: Iterable, epoch: int = 0,
                    max_steps: Optional[int] = None, print_freq: int = 50,
                    timing: Optional[dict] = None) -> Dict[str, float]:
    """Run `train_step` over one epoch of `loader` (a `DataLoader`, whose
    `set_epoch` picks the epoch's order, or any iterable of batches); the
    mean loss and grad norm over the steps (`MetricLogger`'s global
    averages). Raises FloatingPointError on a non-finite loss (the NaN
    guard), which reads the loss on the host every step. `timing`, where
    given, gets each step's wait for its batch (`wait_ms`: the loader and
    the copy's set-up) and the step itself up to that read (`step_ms`)."""
    logger = MetricLogger()
    if hasattr(loader, "set_epoch"):
        loader.set_epoch(epoch)
    total_steps = len(loader) if hasattr(loader, "__len__") else None
    if max_steps is not None and total_steps is not None:
        total_steps = min(total_steps, max_steps)
    batches = logger.log_every(_batches(train_step, loader), print_freq, f"Epoch [{epoch}]",
                               total=total_steps)
    t_wait = time.perf_counter()
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        loss_dict = train_step(batch)
        total = float(loss_dict["total"])
        if timing is not None:
            timing.setdefault("wait_ms", []).append((t0 - t_wait) * 1e3)
            timing.setdefault("step_ms", []).append((time.perf_counter() - t0) * 1e3)
        if not math.isfinite(total):
            raise FloatingPointError(f"Loss is {total}, stopping training (step {i})")
        logger.update(loss=total, grad_norm=float(loss_dict["grad_norm"]))
        if max_steps is not None and i + 1 >= max_steps:
            break
        t_wait = time.perf_counter()
    logger.synchronize_between_processes()
    return {k: m.global_avg for k, m in logger.meters.items()}


def make_eval_step(model, mano_r, mano_l, obj_bank, img_res: float = 224.0,
                   metrics=BATCH_METRICS, smooth_iter: int = 0, device=None):
    """-> step(batch) -> {metric: (B,) tensor} for a batch of numpy arrays or
    tensors: the per-batch metrics among `metrics` (the sequence ones are
    `evaluate_sequences`'). `smooth_iter` > 0 smooths the three predicted
    vertex sets (`arctic_smoothing`) before measuring, as the reference's
    eval-time `--iter` passes do. Runs on `device` (the CUDA card unless
    `device="cpu"`), where the model and the MANO/object tensors must
    already be."""
    device = resolve_device(device)
    metrics = tuple(m for m in metrics if m in BATCH_METRICS)

    @torch.inference_mode()
    def step(batch):
        model.eval()
        batch = to_device(batch, device)
        targets = process_targets(batch, mano_r, mano_l, obj_bank, img_res)
        outputs = model(batch["images"])
        last = {k: v[-1] for k, v in outputs["stacked"].items()}
        pred = decode_predictions(select_queries(last), targets, mano_r, mano_l,
                                  obj_bank, img_res)
        if smooth_iter > 0:
            for k in ("object.v.cam", "mano.v3d.cam.r", "mano.v3d.cam.l"):
                pred[k] = arctic_smoothing(pred[k], smooth_iter).reshape(pred[k].shape)
        return measure_error(pred, targets, metrics)

    step.device = device
    return step


def evaluate(eval_step, loader: Iterable, max_steps: Optional[int] = None,
             timing: Optional[dict] = None) -> Dict[str, float]:
    """Run `eval_step` over `loader` (a `DataLoader` or any iterable of
    batches); nanmean of every metric over frames. `timing`, where given,
    gets each batch's time from its arrival to its rows on the host
    (`batch_ms`)."""
    per_metric: Dict[str, list] = {}
    for i, batch in enumerate(_batches(eval_step, loader)):
        t0 = time.perf_counter()
        for k, v in eval_step(batch).items():
            per_metric.setdefault(k, []).append(v.cpu().numpy())
        if timing is not None:
            timing.setdefault("batch_ms", []).append((time.perf_counter() - t0) * 1e3)
        if max_steps is not None and i + 1 >= max_steps:
            break
    return {k: float(np.nanmean(np.concatenate(v))) for k, v in per_metric.items()}


def make_sequence_eval_step(model, mano_r, mano_l, obj_bank, img_res: float = 224.0,
                            device=None):
    """-> step(batch) -> (pred, targets): the decoded predictions and the
    targets the sequence metrics read (`SEQ_PRED_KEYS`, `SEQ_TARGET_KEYS`),
    camera space, on `device` (the CUDA card unless `device="cpu"`)."""
    device = resolve_device(device)

    @torch.inference_mode()
    def step(batch):
        model.eval()
        batch = to_device(batch, device)
        targets = process_targets(batch, mano_r, mano_l, obj_bank, img_res)
        outputs = model(batch["images"])
        selected = select_queries({k: v[-1] for k, v in outputs["stacked"].items()})
        pred = decode_predictions(selected, targets, mano_r, mano_l, obj_bank, img_res)
        return ({k: pred[k] for k in SEQ_PRED_KEYS},
                {k: targets[k] for k in SEQ_TARGET_KEYS})

    step.device = device
    return step


def evaluate_sequences(seq_step, dataset, batch_size: int = 16,
                       max_frames: Optional[int] = None) -> Dict[str, float]:
    """Whole-sequence metrics over time-ordered frames per (subject, seq,
    view): ACC (acc/h, acc/o, m/s^2) and MDev (mdev/h, mm). Each sequence's
    frames go through `seq_step` in chunks of `batch_size`, the last padded
    with its final frame to a full batch and trimmed after, as the JAX
    package does (one batch shape); `max_frames` keeps a sequence's first
    frames only. Frames are decoded in a thread pool ahead of the step."""
    groups: Dict[str, list] = {}
    for i, n in enumerate(dataset.imgnames):
        sid, seq, view, _ = n.split("/")[-4:]
        groups.setdefault(f"{sid}/{seq}/{view}", []).append(i)

    accs, mdevs = {"acc/h": [], "acc/o": []}, []
    for ids in groups.values():
        ids = sorted(ids, key=lambda i: dataset.imgnames[i])
        if max_frames:
            ids = ids[:max_frames]
        chunks, trims = [], []
        for s in range(0, len(ids), batch_size):
            chunk = ids[s: s + batch_size]
            trims.append(len(chunk))
            chunks.append(chunk + [chunk[-1]] * (batch_size - len(chunk)))
        preds, tgts = [], []
        for samples, trim in zip(prefetch_samples(dataset, chunks), trims):
            p, t = seq_step(collate(samples))
            preds.append({k: v[:trim].cpu().numpy() for k, v in p.items()})
            tgts.append({k: v[:trim].cpu().numpy() for k, v in t.items()})
        pred = {k: np.concatenate([b[k] for b in preds]) for k in preds[0]}
        tgt = {k: np.concatenate([b[k] for b in tgts]) for k in tgts[0]}
        acc = eval_acc_pose({k: torch.from_numpy(v) for k, v in pred.items()},
                            {k: torch.from_numpy(v) for k, v in tgt.items()})
        for k in accs:
            accs[k].append(acc[k].numpy())
        md = eval_motion_deviation(pred, tgt)
        if len(md["mdev/h"]):
            mdevs.append(md["mdev/h"])

    out = {k: float(np.nanmean(np.concatenate(v))) for k, v in accs.items() if v}
    out["mdev/h"] = float(np.nanmean(np.concatenate(mdevs))) if mdevs else float("nan")
    return out
