"""The train step and the serving loop.

Port of `uvhand_tpu/engine.py`:
  - train (`make_fused_train_step`, `train_one_epoch`): GT preprocessing ->
    forward in train mode -> criterion -> backward -> global-norm clip ->
    AdamW step, with the NaN-loss guard;
  - serve (`make_eval_step`, `evaluate`, the reference's `test_pose`): GT
    preprocessing -> forward -> query select (a temporal head's refined
    parameters, where the model has one) -> decode -> (optional `--iter`
    smoothing) -> per-frame metrics;
  - temporal windows: a batch of B windows of T frames trains on every
    frame (`collate_tempo_train(split_window=True)`) or on the centre
    frames (`center_index`, `select_output_frames`);
  - sequence metrics (`make_sequence_eval_step`, `evaluate_sequences`): ACC
    and MDev over each (subject, sequence, view) in time order.
  - the AssemblyHands / H2O / FPHA model (`make_assembly_train_step`,
    `make_assembly_eval_step`, `evaluate_assembly`): the JAX CLI's
    `run_coco` steps, on COCO-format batches (`COCO_KEYS`).
The loops take a `data.loader.DataLoader` (batches copied to the card by
`device_prefetch`) or any iterable of in-memory batches. Over several
processes (`train.launch.init_multihost`) each holds a share of the global
batch: the train step computes the loss of the global batch on every
process and sums the gradients (`make_fused_train_step(process_group=...)`),
and `evaluate` gathers the per-frame rows before the means.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .data.arctic import collate
from .data.loader import device_prefetch, prefetch_samples
from .data.process import process_targets
from .device import resolve_device
from .evaluation.decode import decode_predictions
from .evaluation.mdev import eval_motion_deviation
from .evaluation.metrics import eval_acc_pose, measure_error
from .losses.criterion import arctic_criterion, select_queries
from .train.mesh import all_gather_rows, all_reduce_grads, broadcast_grads, gather_batch
from .train.state import StochasticRounding, clip_by_global_norm_, global_norm
from .utils.logging import MetricLogger
from .utils.spans import recording, span, steps
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
#: targets and the 2D hand GT that `ArcticDataset` emits for the criterion,
#: and the centre frames' rows of a window batch (`collate_tempo_train(
#: split_window=False)`)
TRAIN_KEYS = EVAL_KEYS + (
    "labels", "keypoints", "target_valid", "joints_valid_r", "joints_valid_l",
    "mano.j2d.norm.r", "mano.j2d.norm.l", "center_index",
)

#: the spans (`utils.spans`) of a train step or an eval batch that follow
#: one another, so that no two overlap in time: the loops' `wait` for the
#: batch, the steps' stages (`targets` only with preprocess) and the loops'
#: `read` of the result. Left out, as they hold or lie inside these: `step`,
#: `batch`, and the criterion's `match` and `layer_losses`
TRAIN_STAGES = ("wait", "targets", "forward", "criterion", "backward", "clip+optimizer",
                "decode", "metrics", "read")


def to_device(batch: Dict[str, np.ndarray], device, keys=EVAL_KEYS) -> Dict[str, torch.Tensor]:
    """The `keys` of a batch of numpy arrays or tensors as tensors on
    `device` (a tensor already there is taken as it is)."""
    return {k: batch[k].to(device) if isinstance(batch[k], torch.Tensor)
            else torch.as_tensor(np.asarray(batch[k]), device=device)
            for k in keys if k in batch}


def select_output_frames(outputs, idx):
    """The rows `idx` of the model outputs that the criterion reads: the
    stacked layers (batch on axis 1), the `interm_outputs` and the
    `temporal_selected` parameters (axis 0). Temporal centre-frame training
    (`split_window=False`, tempo_dataset.py:97-103) runs the model on all
    B*T window frames and the criterion on the B centre frames only."""
    out = dict(outputs)
    out["stacked"] = {k: None if v is None else v[:, idx] for k, v in outputs["stacked"].items()}
    for key in ("interm_outputs", "temporal_selected"):
        if outputs.get(key) is not None:
            out[key] = {k: None if v is None else v[idx] for k, v in outputs[key].items()}
    return out


def gather_global_batch(outputs, targets, group):
    """The model outputs that the criterion reads (the stacked decoder
    layers and the dn queries' per-layer outputs, batch on axis 1, the
    encoder's `interm_outputs`, the temporal head's `temporal_selected` and
    the `dn_meta`, batch on axis 0) and the
    processed targets (but the images) of the global batch, every
    process's share in rank order (`train.mesh.gather_batch`): only this
    process's rows carry autograd."""
    out = {"stacked": {k: gather_batch(v, 1, group) for k, v in outputs["stacked"].items()}}
    for key in ("interm_outputs", "temporal_selected"):
        if key in outputs:
            out[key] = {k: gather_batch(v, 0, group) for k, v in outputs[key].items()}
    if "dn_outputs" in outputs:
        dn = outputs["dn_outputs"]
        out["dn_outputs"] = {k: gather_batch(v, 1, group) for k, v in dn.items()
                             if k != "dn_meta"}
        out["dn_outputs"]["dn_meta"] = {k: gather_batch(v, 0, group)
                                        for k, v in dn["dn_meta"].items()}
    return out, {k: gather_batch(v, 0, group) for k, v in targets.items() if k != "images"}


def dn_targets(targets):
    """The CDN inputs of a batch's processed targets: labels, keypoints, and
    the slots valid in a valid frame."""
    return {"labels": targets["labels"], "keypoints": targets["keypoints"],
            "target_valid": targets["target_valid"].bool() & (targets["is_valid"][:, None] > 0)}


def make_loss_fn(model, mano_r, mano_l, obj_bank, img_res: float = 224.0, weights=None,
                 cost_class: float = 1.5, cost_keypoint: float = 4.0, preprocess: bool = True,
                 process_group=None):
    """-> loss_fn(batch of tensors, generator, dn_meta=None) -> (total, loss
    dict): the training objective (the criterion reads from the outputs
    whether the model is single-stage). The GT preprocessing carries no
    gradient. `preprocess=False` reads processed targets from
    `batch["targets"]`. A model with `use_dn` gets the batch's CDN targets
    (`dn_targets`), as the JAX package's step feeds them; a given `dn_meta`
    (this process's rows) replaces the CDN draw. With a `process_group`,
    `batch` is this process's share of the global batch, and the loss is
    the global batch's (`gather_global_batch`). A batch with `center_index`
    (a window batch whose targets are its windows' centre frames) runs the
    model on every frame and the criterion on those rows
    (`select_output_frames`), each process on its own rows before the
    gather; it feeds no CDN targets, as the JAX package does."""
    use_dn = getattr(model, "use_dn", False)

    def loss_fn(batch, generator, dn_meta=None):
        batch = dict(batch)
        center_index = batch.pop("center_index", None)
        if preprocess:
            with torch.no_grad(), span("targets"):
                targets = process_targets(batch, mano_r, mano_l, obj_bank, img_res)
        else:
            targets = batch["targets"]
        with span("forward"):
            dn = ({} if not use_dn or center_index is not None
                  else dict(dn_targets=dn_targets(targets), dn_meta=dn_meta))
            outputs = model(batch["images"], generator=generator, **dn)
        with span("criterion"):
            if center_index is not None:
                outputs = select_output_frames(outputs, center_index.long())
            if process_group is not None:
                outputs, targets = gather_global_batch(outputs, targets, process_group)
            return arctic_criterion(outputs, targets, mano_r, mano_l, obj_bank, img_res=img_res,
                                    weights=weights, cost_class=cost_class,
                                    cost_keypoint=cost_keypoint)

    return loss_fn


def make_fused_train_step(model, mano_r, mano_l, obj_bank, optimizer, img_res: float = 224.0,
                          weights=None, cost_class: float = 1.5, cost_keypoint: float = 4.0,
                          clip_max_norm: float = 0.1, preprocess: bool = True,
                          generator: Optional[torch.Generator] = None, device=None,
                          process_group=None, model_group=None):
    """-> step(batch) -> loss dict (0-d tensors, with `grad_norm`) for a
    batch of numpy arrays or tensors: one optimizer update.

    Runs on `device` (the CUDA card unless `device="cpu"`), where the model,
    the MANO/object tensors and the optimizer's parameters must already be.
    Dropout, the feature mask and the CDN queries draw from `generator` (a
    fresh one on the device, seeded 0, when none is given). `grad_norm` is
    the global norm of the raw gradients, taken before the clip. Every parameter gets a
    gradient, zero where the loss does not reach it, so AdamW decays all of
    them as optax does. With bfloat16 parameters (the optimizer is a
    `train.state.StochasticRounding`) the gradients are widened to float32
    before the norm, the clip and the update, as the JAX package's
    `float32_optimizer_state` does. A learning-rate schedule is stepped by
    the caller after each step (`train.state.scheduled`). The stages are
    spans (`utils.spans`) named in `TRAIN_STAGES`.

    With a `process_group` (the JAX package's data axis), `batch` is this
    process's share of the global batch (`data.loader.DataLoader(rank=...,
    world_size=...)`): each process runs the GT preprocessing and the
    forward on its rows, gathers the outputs and targets of every process
    and computes the loss of the global batch, as the JAX step does in one
    program (the per-hand gates, masked means, frame pairs and `num_boxes`
    span the global batch). Its backward gives this process's share of the
    gradient; the shares are summed (`train.mesh.all_reduce_grads`), and
    every process then takes the same clip and update, so the parameters
    stay equal across processes. Each process should draw dropout from a
    generator of its own (`train.mesh.process_seed`).

    With a `model_group` as well (the model axis of `train.mesh.make_mesh`;
    `process_group` is then its data axis), the parameters that
    `train.mesh.shard_state` sharded hold this process's rows: their
    gradients are summed over the data axis, the other parameters' too,
    which then take the gradient of the model axis's first process (its
    processes compute the same one, but for the last bits of atomics), so
    that their copies stay equal; the global norm counts each shard once
    (`train.state.global_norm`), and each process steps its shards. The mp
    processes of a dp row take the same rows and draw alike
    (`process_seed` of the dp rank)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    loss_fn = make_loss_fn(model, mano_r, mano_l, obj_bank, img_res=img_res, weights=weights,
                           cost_class=cost_class, cost_keypoint=cost_keypoint,
                           preprocess=preprocess, process_group=process_group)
    float32_update = isinstance(optimizer, StochasticRounding)
    params = (optimizer.bf16_params if float32_update
              else [p for group in optimizer.param_groups for p in group["params"]])

    def step(batch):
        if preprocess:
            batch = to_device(batch, device, TRAIN_KEYS)
        model.train()
        optimizer.zero_grad(set_to_none=False)
        total, loss_dict = loss_fn(batch, generator)
        with span("backward"):
            total.backward()
        with span("clip+optimizer"):
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad.float() if float32_update else p.grad for p in params]
            sharded = [hasattr(p, "mp_shard") for p in params] if model_group is not None else []
            if process_group is not None:
                all_reduce_grads(grads, process_group)
            if model_group is not None:
                broadcast_grads([g for g, s in zip(grads, sharded) if not s], model_group)
            norm = global_norm(grads, sharded, model_group)
            if clip_max_norm > 0:
                clip_by_global_norm_(grads, clip_max_norm, norm)
            if float32_update:
                optimizer.step(grads=grads)
            else:
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
    given, gets the loop's spans (`utils.spans`: each step's `wait` for its
    batch, the `step` up to and with the loss's `read`, and the step's
    stages inside it) in `timing["spans"]`, and the durations of the
    `wait` (the loader and the copy's set-up) and `step` spans in
    `wait_ms` and `step_ms`."""
    logger = MetricLogger()
    if hasattr(loader, "set_epoch"):
        loader.set_epoch(epoch)
    total_steps = len(loader) if hasattr(loader, "__len__") else None
    if max_steps is not None and total_steps is not None:
        total_steps = min(total_steps, max_steps)
    batches = logger.log_every(_batches(train_step, loader), print_freq, f"Epoch [{epoch}]",
                               total=total_steps)
    with recording(timing, wait_ms="wait", step_ms="step"):
        for i, batch in steps(batches):
            with span("step"):
                loss_dict = train_step(batch)
                with span("read"):
                    total = float(loss_dict["total"])
            if not math.isfinite(total):
                raise FloatingPointError(f"Loss is {total}, stopping training (step {i})")
            logger.update(loss=total, grad_norm=float(loss_dict["grad_norm"]))
            if max_steps is not None and i + 1 >= max_steps:
                break
    logger.synchronize_between_processes()
    return {k: m.global_avg for k, m in logger.meters.items()}


def selected_params(outputs):
    """The parameters the serving path decodes: a temporal head's refined
    ones where the model has one, else the last layer's selected queries."""
    if outputs.get("temporal_selected") is not None:
        return outputs["temporal_selected"]
    return select_queries({k: v[-1] for k, v in outputs["stacked"].items() if v is not None})


def make_eval_step(model, mano_r, mano_l, obj_bank, img_res: float = 224.0,
                   metrics=BATCH_METRICS, smooth_iter: int = 0, device=None):
    """-> step(batch) -> {metric: (B,) tensor} for a batch of numpy arrays or
    tensors: the per-batch metrics among `metrics` (the sequence ones are
    `evaluate_sequences`'). `smooth_iter` > 0 smooths the three predicted
    vertex sets (`arctic_smoothing`) before measuring, as the reference's
    eval-time `--iter` passes do. Runs on `device` (the CUDA card unless
    `device="cpu"`), where the model and the MANO/object tensors must
    already be. The stages are spans (`utils.spans`) named in
    `TRAIN_STAGES`: `targets`, `forward`, `decode` (the query select, the
    decode and the smoothing) and `metrics`."""
    device = resolve_device(device)
    metrics = tuple(m for m in metrics if m in BATCH_METRICS)

    @torch.inference_mode()
    def step(batch):
        model.eval()
        batch = to_device(batch, device)
        with span("targets"):
            targets = process_targets(batch, mano_r, mano_l, obj_bank, img_res)
        with span("forward"):
            outputs = model(batch["images"])
        with span("decode"):
            pred = decode_predictions(selected_params(outputs), targets, mano_r, mano_l,
                                      obj_bank, img_res)
            if smooth_iter > 0:
                for k in ("object.v.cam", "mano.v3d.cam.r", "mano.v3d.cam.l"):
                    pred[k] = arctic_smoothing(pred[k], smooth_iter).reshape(pred[k].shape)
        with span("metrics"):
            return measure_error(pred, targets, metrics)

    step.device = device
    return step


def evaluate(eval_step, loader: Iterable, max_steps: Optional[int] = None,
             timing: Optional[dict] = None, group=None) -> Dict[str, float]:
    """Run `eval_step` over `loader` (a `DataLoader` or any iterable of
    batches); nanmean of every metric over frames. Over several processes
    each runs its share of the batches, and the per-frame rows of every
    process of `group` (the default group; under a model axis its data
    axis, whose processes hold other rows) are gathered before the means
    (`train.mesh.all_gather_rows`), so every process reports the global
    scores. `timing`, where given, gets the loop's spans (`utils.spans`:
    each batch's `wait`, the `batch` from its arrival to its rows on the
    host, which ends in their `read`, and the step's stages inside it) in
    `timing["spans"]`, and the `batch` spans' durations in `batch_ms`."""
    per_metric: Dict[str, list] = {}
    with recording(timing, batch_ms="batch"):
        for i, batch in steps(_batches(eval_step, loader)):
            with span("batch"):
                out = eval_step(batch)
                with span("read"):
                    for k, v in out.items():
                        per_metric.setdefault(k, []).append(v.cpu().numpy())
            if max_steps is not None and i + 1 >= max_steps:
                break
    rows = all_gather_rows({k: np.concatenate(v) for k, v in per_metric.items()}, group)
    return {k: float(np.nanmean(v)) for k, v in rows.items()}


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
        pred = decode_predictions(selected_params(model(batch["images"])), targets, mano_r,
                                  mano_l, obj_bank, img_res)
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


# ------------------------------------------------ AssemblyHands / H2O / FPHA

#: the keys of a COCO-format batch (`data/coco_hands.py`)
COCO_KEYS = ("images", "labels", "keypoints63", "target_valid")


def make_assembly_train_step(model, optimizer, clip_max_norm: float = 0.1,
                             generator: Optional[torch.Generator] = None, device=None,
                             process_group=None):
    """-> step(batch) -> loss dict (0-d tensors, with `grad_norm`): one
    update of an `AssemblyDETR`, as the JAX CLI's `run_coco` takes it: the
    model in train mode (dropout from `generator`, a fresh one seeded 0 when
    none is given), `assembly_criterion` with its defaults (no per-joint
    mask), the gradient, the global-norm clip and the optimizer's step.
    Every parameter gets a gradient, zero where the loss does not reach it.
    With a `process_group`, `batch` is this process's share of the global
    batch: `num_boxes` is the global batch's, each process's backward gives
    its share of the gradient, the shares are summed, and the loss terms
    are the global batch's (`cardinality_error` the mean over processes).
    The stages are spans (`utils.spans`) named in `TRAIN_STAGES` (no
    `targets`)."""
    from .models.assembly import assembly_criterion

    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch):
        b = to_device(batch, device, COCO_KEYS)
        model.train()
        optimizer.zero_grad(set_to_none=False)
        num_boxes = None
        if process_group is not None:
            num_boxes = b["target_valid"].sum().float()
            torch.distributed.all_reduce(num_boxes, group=process_group)
        with span("forward"):
            out = model(b["images"], generator)
        with span("criterion"):
            total, loss_dict = assembly_criterion(out, b["labels"], b["keypoints63"],
                                                  b["target_valid"], num_boxes=num_boxes)
        with span("backward"):
            total.backward()
        with span("clip+optimizer"):
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            if process_group is not None:
                all_reduce_grads(grads, process_group)
            norm = global_norm(grads)
            if clip_max_norm > 0:
                clip_by_global_norm_(grads, clip_max_norm, norm)
            optimizer.step()
        loss_dict = {k: v.detach() for k, v in loss_dict.items()}
        if process_group is not None:
            names = sorted(loss_dict)
            terms = torch.stack([loss_dict[k] for k in names])
            torch.distributed.all_reduce(terms, group=process_group)
            loss_dict = dict(zip(names, terms.unbind()))
            loss_dict["cardinality_error"] = (loss_dict["cardinality_error"]
                                              / torch.distributed.get_world_size(process_group))
        loss_dict["grad_norm"] = norm
        return loss_dict

    step.device = device
    return step


def make_assembly_eval_step(model, device=None):
    """-> step(batch) -> {"pred", "gt", "valid"}: for each GT slot the
    keypoints (B, 3, 63) of the last layer's query most probable for the
    slot's label (`models/assembly.py::select_slots`), as the JAX CLI's
    `run_coco` evaluates, beside the slot's GT and validity."""
    from .models.assembly import select_slots

    device = resolve_device(device)

    @torch.inference_mode()
    def step(batch):
        b = to_device(batch, device, COCO_KEYS)
        model.eval()
        st = model(b["images"])["stacked"]
        return {"pred": select_slots(st["pred_logits"][-1], st["pred_keypoints"][-1],
                                     b["labels"]),
                "gt": b["keypoints63"], "valid": b["target_valid"]}

    step.device = device
    return step


def evaluate_assembly(eval_step, loader: Iterable, img_res: int,
                      max_steps: Optional[int] = None,
                      timing: Optional[dict] = None) -> Dict[str, float]:
    """`assembly_keypoint_metrics` (pixel MPJPE in uv at `img_res` x
    `img_res`, depth MAE) over the valid slots of every batch of `loader`;
    over several processes the rows of every process are gathered first.
    `timing` gets the loop's spans and each batch's `batch_ms`, as
    `evaluate`'s."""
    from .evaluation.coco_eval import assembly_keypoint_metrics

    parts: Dict[str, list] = {}
    with recording(timing, batch_ms="batch"):
        for i, batch in steps(_batches(eval_step, loader)):
            with span("batch"):
                out = eval_step(batch)
                with span("read"):
                    for k, v in out.items():
                        parts.setdefault(k, []).append(v.cpu().numpy())
            if max_steps is not None and i + 1 >= max_steps:
                break
    rows = all_gather_rows({k: np.concatenate(v) for k, v in parts.items()})
    return assembly_keypoint_metrics(rows["pred"], rows["gt"], rows["valid"],
                                     img_size=(img_res, img_res))
