"""Throughput of the port's own programs on one card.

    python -m uvhand_tpu_torch.bench [--device cpu] [--hidden_dim 64 ...]

Counterpart of the root `bench.py`, which times the JAX package. It times
the programs users run: `engine.make_fused_train_step` (GT preprocessing,
forward in train mode, criterion, backward, clip, AdamW), the function the
CLI trains with, and the serving path (forward, `select_queries`,
`decode_predictions`, no GT), on one batch of `UVHAND_BENCH_BATCH` frames
(default 16) read from a synthetic ARCTIC root (`data/arctic.py::
make_synthetic_root`) through `ArcticDataset` and `DataLoader`, with
weights drawn from a seed and synthetic MANO and objects. The model is
arctic_sf at full width by default (R50, 224x224, d=256, 8 heads, 6+6
layers, FFN 1024, 300 queries, two-stage, box refinement); the flags
shrink it for a test on the CPU.

Output: one JSON line a measurement, each printed and flushed as soon as it
lands. The FIRST line is the headline, measured first:
  {"metric": "train_frames_per_sec_chip", "value": N, "unit": "frames/s",
   "vs_baseline": N, "dtype": "bfloat16", ...}
(the bf16 compute mode). Then, each only while the run is under
UVHAND_BENCH_BUDGET_S seconds (default 1200), and each as its own line
(an error in one is printed as its line, and the rest go on): the fp32
train step, the enc_lite train step and serving at 4x the batch
(hi_every UVHAND_BENCH_ENC_LITE_HI, default 6), bf16 serving, the window-32
temporal train step (`train_frames_per_sec_chip_window32`: one window of 32
frames from `TempoTrainDataset` on a synthetic root of max(32 + 22, B + 1)
frames, bf16, remat, frames/s counting all 32 frames), the bf16 train step
of the same model on the Swin-L backbone (`train_frames_per_sec_chip_swin`,
the reference's `swin_L_384_22k`), fp32 serving. The window-32 and Swin-L
rows carry a `note` (BASELINE config 3 and config 2) and no `vs_baseline`,
as in the root bench: the A100 estimate is arctic_sf on the R50 at B=16.

A time is the host clock over UVHAND_BENCH_SCAN (default 120) steps or
batches after a warm-up one (which builds the kernels and the
optimizer's state), ending in `torch.cuda.synchronize()`; the
serving inputs vary between calls. Knobs, as in the root bench:
UVHAND_BENCH_DTYPE=bfloat16|float32 (the headline mode alone),
UVHAND_BENCH_ONLY=infer (serving alone), UVHAND_BENCH_INFER=0 and
UVHAND_BENCH_LITE=0 (drop those lines), UVHAND_BENCH_MODEL=dino (the DINO
variant: contrastive denoising fed every train step, look-forward-twice;
its decoder runs the 300 matching and 198 dn queries) and
UVHAND_BENCH_BACKBONE=convnext|swin (ConvNeXt-XL, Swin-L),
UVHAND_BENCH_WINDOW=T (every line on one temporal train batch of
max(B // T, 1) windows of T frames centred on frames of a synthetic root, `collate_tempo_train`, in place of the B frames; no window32
line then), UVHAND_BENCH_SPLIT=0 (the window batches keep their centre
frames' targets only, `center_index`; the serving lines, which need every
frame's camera, are skipped then), UVHAND_BENCH_TEMPORAL=lstm|vivit (the
in-model temporal head over the windows, on every window batch's model).
Remat is on where a batch holds 24 frames or more, as the root bench
selects it; UVHAND_BENCH_REMAT=0|1 overrides that choice on every line.
UVHAND_BENCH_SR=1 trains the bf16 train lines with bfloat16 parameters and
stochastic-rounded updates (`param_dtype=torch.bfloat16`,
`train/state.py::SRAdamW`); UVHAND_BENCH_ENC_LITE=1 puts enc_lite on every
line (hi_every UVHAND_BENCH_ENC_LITE_HI, default 3; the enc_lite lines keep
theirs); UVHAND_BENCH_EXTRA_MODES=0 drops the window-32 and Swin-L lines,
which a UVHAND_BENCH_WINDOW run drops too. UVHAND_BENCH_PROFILE=<logdir>:
after a line's timed run, the same program runs again as many times under
torch.profiler, and its trace goes to
`<logdir>/<dtype>/<metric>.json` (a serving line's to
`<logdir>/infer_<dtype>/`, the root bench's directories); the value printed
is the unprofiled run's, and the row names the trace. The root bench's
UVHAND_BENCH_S2D has no counterpart: the port has no `stem_s2d` (a TPU
rewrite of the same stem). Every line names its model, backbone, remat and
dtype, and `sr` and `enc_lite` where they are set. TF32 is off on the card,
as in the CLI.

The reference publishes no throughput (BASELINE.md). `vs_baseline` is
against REFERENCE_FPS_ESTIMATE, an estimate of the CUDA reference's train
throughput for arctic_sf on one A100 (R50, 224x224, 6+6, batch 16), not a
measurement.

It runs on the card and raises where there is none, unless given
`--device cpu`.
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import os
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch

REFERENCE_FPS_ESTIMATE = 140.0  # frames/s per A100, train step (see the docstring)
WARMUP = 1
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}
#: the rows of other configurations than the estimate's, with the root bench's notes
NOTES = {"train_frames_per_sec_chip_window32": "BASELINE config-3 temporal train, remat",
         "train_frames_per_sec_chip_swin": "BASELINE config-2 backbone"}


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def get_args_parser():
    p = argparse.ArgumentParser("uvhand_tpu_torch.bench")
    p.add_argument("--device", default=None,
                   help="cuda (the default: the card; raises without one) or cpu")
    p.add_argument("--enc_layers", default=6, type=int)
    p.add_argument("--dec_layers", default=6, type=int)
    p.add_argument("--hidden_dim", default=256, type=int)
    p.add_argument("--dim_feedforward", default=1024, type=int)
    p.add_argument("--nheads", default=8, type=int)
    p.add_argument("--num_queries", default=300, type=int)
    p.add_argument("--img_res", default=224, type=int)
    return p


BACKBONES = {"": "resnet50", "resnet50": "resnet50", "convnext": "convnext_xlarge_22k",
             "swin": "swin_L_384_22k"}


def first_batch(args, batch_size: int, window: int = 0, split_window: bool = True) -> dict:
    """The first batch of a synthetic ARCTIC root through the data path, its
    object GT consistent with the synthetic bank: `batch_size` frames
    (`ArcticDataset`, `DataLoader`), or with a `window` max(batch_size //
    window, 1) windows of `window` frames centred on the first frames of a
    sequence of max(window + 22, batch_size + 1) frames (`TempoTrainDataset`,
    `collate_tempo_train(split_window=...)`), as the root bench's
    `_make_window_batch` takes it."""
    from .data import arctic
    from .data.loader import DataLoader
    from .geometry import objects

    bank = objects.synthetic_object_bank(2, device="cpu")
    with tempfile.TemporaryDirectory(prefix="uvhand_bench_") as root:
        if window:
            arctic.make_synthetic_root(root, num_seqs=1, frames=max(window + 22, batch_size + 1),
                                       views=1, obj_bank=bank)
        else:
            arctic.make_synthetic_root(root, num_seqs=2, frames=(batch_size + 1) // 2, views=1,
                                       obj_bank=bank)
        ds = arctic.ArcticDataset(root, "p1", "train", img_res=args.img_res,
                                  kp3d_cano=bank.kp_bottom.numpy())
        if window:
            loader = DataLoader(arctic.TempoTrainDataset(ds, window, split_window=split_window),
                                max(batch_size // window, 1), shuffle=False, seed=0,
                                collate_fn=functools.partial(arctic.collate_tempo_train,
                                                             split_window=split_window))
        else:
            loader = DataLoader(ds, batch_size, shuffle=False, seed=0)
        try:
            return next(iter(loader))
        finally:
            loader.close()


class Bench:
    """The batch, the world and the model of one bench run (`model_name`
    "deformable_detr" or "dino", `backbone` one of `BACKBONES`' values); a
    `window` batch (`first_batch`) trains the model with the `temporal`
    head ("none", "lstm" or "vivit") over its windows. Remat is on where
    the batch holds 24 frames or more (a B=32 step without it needs ~2x the
    memory of one with it, PERF.md section 5)."""

    def __init__(self, args, device, batch_size: int, steps: int,
                 model_name: str = "deformable_detr", backbone: str = "resnet50",
                 window: int = 0, split_window: bool = True, temporal: str = "none",
                 remat: Optional[bool] = None, enc_lite_hi: int = 0, profile: str = ""):
        from .geometry import mano, objects

        self.args, self.device, self.steps = args, device, steps
        self.dino, self.backbone = model_name == "dino", backbone
        self.window, self.temporal = window, temporal if window else "none"
        self.enc_lite_hi, self.profile = enc_lite_hi, profile
        batch = first_batch(args, batch_size, window, split_window)
        self.frames = int(batch["images"].shape[0])
        self.remat = self.frames >= 24 if remat is None else remat
        # serving needs every frame's camera and object index
        self.serves = batch["intrinsics"].shape[0] == self.frames
        self.batch = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}
        self.world = (mano.synthetic_mano(0, True, device=device),
                      mano.synthetic_mano(1, False, device=device),
                      objects.synthetic_object_bank(2, device=device))

    def model(self, dtype: torch.dtype, enc_lite_hi: int = 0, sr: bool = False):
        """The model in `dtype` compute; enc_lite with `enc_lite_hi` (else
        the run's `UVHAND_BENCH_ENC_LITE` choice); bfloat16 parameters with
        `sr`."""
        from .models.detr import UVHandDETR

        a = self.args
        enc_lite_hi = enc_lite_hi or self.enc_lite_hi
        return UVHandDETR(num_queries=a.num_queries, d_model=a.hidden_dim, n_heads=a.nheads,
                          num_encoder_layers=a.enc_layers, num_decoder_layers=a.dec_layers,
                          dim_feedforward=a.dim_feedforward, compute_dtype=dtype,
                          param_dtype=torch.bfloat16 if sr else torch.float32,
                          enc_lite=enc_lite_hi > 0, enc_lite_hi_every=enc_lite_hi or 3,
                          dino_variant=self.dino, use_dn=self.dino,
                          look_forward_twice=self.dino, backbone=self.backbone,
                          remat=self.remat, temporal_head=self.temporal,
                          temporal_window=self.window if self.temporal != "none" else 0,
                          generator=torch.Generator().manual_seed(0), device=self.device)

    def _timed(self, one, trace: str = "") -> float:
        """Seconds of `self.steps` calls of `one(i)` after WARMUP ones; each
        returns a 0-d tensor, all of which must be finite. With a `trace`
        path, the same calls then run again under torch.profiler, whose
        trace goes there; the time returned is the unprofiled run's."""
        out = [one(i) for i in range(WARMUP)]
        self._sync()
        t0 = time.perf_counter()
        out += [one(WARMUP + i) for i in range(self.steps)]
        self._sync()
        dt = time.perf_counter() - t0
        if not bool(torch.isfinite(torch.stack(out).float()).all()):
            raise FloatingPointError(f"non-finite results: {out}")
        if trace:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            with profile(activities=activities) as prof:
                for i in range(self.steps):
                    one(WARMUP + self.steps + i)
                self._sync()
            os.makedirs(os.path.dirname(trace), exist_ok=True)
            prof.export_chrome_trace(trace)
        return dt

    def trace(self, metric: str, dtype: torch.dtype) -> str:
        """Where a line's trace goes under UVHAND_BENCH_PROFILE (else "")."""
        if not self.profile:
            return ""
        where = ("infer_" if metric.startswith("infer_") else "") + DTYPE_NAMES[dtype]
        return os.path.join(self.profile, where, f"{metric}.json")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, dtype: torch.dtype, enc_lite_hi: int = 0, sr: bool = False,
              trace: str = "") -> float:
        """Frames/s of the fused train step in `dtype` compute (bfloat16
        parameters, stochastic-rounded updates with `sr`)."""
        from . import engine
        from .train.state import create_optimizer

        model = self.model(dtype, enc_lite_hi, sr)
        step = engine.make_fused_train_step(
            model, *self.world, create_optimizer(model), img_res=float(self.args.img_res),
            generator=torch.Generator(device=self.device).manual_seed(0), device=self.device)
        self.param_dtypes = sorted({str(p.dtype) for p in model.parameters()})
        return self.frames * self.steps / self._timed(lambda i: step(self.batch)["total"], trace)

    def infer(self, dtype: torch.dtype, enc_lite_hi: int = 0, repeat: int = 1,
              trace: str = "") -> float:
        """Frames/s of serving: image -> decoded MANO and object meshes and
        camera-space joints, no GT (the root bench's `measure_infer`); the
        batch `repeat` times over."""
        from .evaluation.decode import decode_predictions
        from .losses.criterion import select_queries

        model = self.model(dtype, enc_lite_hi)
        images = torch.cat([self.batch["images"]] * repeat)
        meta = {k: torch.cat([self.batch[k]] * repeat) for k in ("intrinsics", "query_idx")}

        @torch.inference_mode()
        def one(i):
            out = model(images + i * 1e-6)  # inputs vary between calls
            last = {k: v[-1] for k, v in out["stacked"].items() if v is not None}
            pred = decode_predictions(select_queries(last), meta, *self.world,
                                      float(self.args.img_res))
            return pred["mano.j3d.cam.r"].sum()

        return self.frames * repeat * self.steps / self._timed(one, trace)


def main(argv=None) -> None:
    from .device import resolve_device

    args = get_args_parser().parse_args(argv)
    t_start = time.monotonic()
    device = resolve_device(args.device)
    if device.type == "cuda":
        # float32 stays float32 (the parity mode), as in the CLI
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    env = os.environ.get
    batch_size = int(env("UVHAND_BENCH_BATCH", 16))
    only_dtype = env("UVHAND_BENCH_DTYPE", "")
    budget_s = float(env("UVHAND_BENCH_BUDGET_S", 1200))
    hi = int(env("UVHAND_BENCH_ENC_LITE_HI", "6"))
    model_name = env("UVHAND_BENCH_MODEL", "") or "deformable_detr"
    if model_name not in ("deformable_detr", "dino"):
        raise ValueError(f"UVHAND_BENCH_MODEL={model_name!r}: deformable_detr or dino")
    backbone = BACKBONES[env("UVHAND_BENCH_BACKBONE", "")]
    window = int(env("UVHAND_BENCH_WINDOW", "0"))
    temporal = env("UVHAND_BENCH_TEMPORAL", "") or "none"
    split = env("UVHAND_BENCH_SPLIT", "1") == "1"
    steps = int(env("UVHAND_BENCH_SCAN", 120))
    remat = {"": None, "0": False, "1": True}[env("UVHAND_BENCH_REMAT", "")]
    sr = env("UVHAND_BENCH_SR", "") == "1"
    # the root bench's measure() reads ENC_LITE_HI with a default of 3
    all_lite_hi = int(env("UVHAND_BENCH_ENC_LITE_HI", "3")) if env(
        "UVHAND_BENCH_ENC_LITE", "") == "1" else 0
    profile = env("UVHAND_BENCH_PROFILE", "")
    knobs = dict(remat=remat, enc_lite_hi=all_lite_hi, profile=profile)
    bench = Bench(args, device, batch_size, steps, model_name, backbone, window, split, temporal,
                  **knobs)
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    where = {"batch": bench.frames, "model": model_name, "backbone": backbone, "device": card,
             "remat": bench.remat}
    if window:
        where.update(window=window, split_window=split, temporal_head=bench.temporal)
    if all_lite_hi:
        where.update(enc_lite=True, enc_lite_hi_every=all_lite_hi)

    def train_line(dtype, enc_lite_hi=0, on=bench):
        """(the train step's rate, the row's knobs): bf16 lines take SR."""
        def run(metric):
            with_sr = sr and dtype == torch.bfloat16
            v = on.train(dtype, enc_lite_hi, with_sr, on.trace(metric, dtype))
            return v, {"sr": True, "param_dtypes": on.param_dtypes} if with_sr else {}
        return run

    def infer_line(dtype, enc_lite_hi=0, repeat=1):
        def run(metric):
            return bench.infer(dtype, enc_lite_hi, repeat, bench.trace(metric, dtype)), {}
        return run

    def emit_row(metric, run, meta):
        v, extra = run(metric)
        row = {"metric": metric, "value": v, "unit": "frames/s", **where, **meta, **extra}
        if metric in NOTES:
            row["note"] = NOTES[metric]
        elif metric.startswith("train_"):
            row["vs_baseline"] = v / REFERENCE_FPS_ESTIMATE
        if profile:
            row["trace"] = bench.trace(metric, DTYPES[row["dtype"]])
        _emit(row)

    if env("UVHAND_BENCH_ONLY", "") == "infer":
        dt = only_dtype or "bfloat16"
        emit_row("infer_frames_per_sec_chip", infer_line(DTYPES[dt]), {"dtype": dt})
        return

    # the headline: measured first, printed first, flushed
    dt = only_dtype or "bfloat16"
    emit_row("train_frames_per_sec_chip", train_line(DTYPES[dt]), {"dtype": dt})
    if only_dtype:
        return

    lite = {"dtype": "bfloat16", "mode": "enc_lite", "enc_lite_hi_every": hi}
    extras = [("train_frames_per_sec_chip_fp32", train_line(torch.float32),
               {"dtype": "float32"})]
    if env("UVHAND_BENCH_LITE", "1") == "1":
        extras += [("train_frames_per_sec_chip_enc_lite", train_line(torch.bfloat16, hi), lite),
                   ("infer_frames_per_sec_chip_enc_lite",
                    infer_line(torch.bfloat16, hi, repeat=4), {**lite, "batch": 4 * bench.frames})]
    infer = env("UVHAND_BENCH_INFER", "1") == "1"
    if infer:
        extras.append(("infer_frames_per_sec_chip", infer_line(torch.bfloat16),
                       {"dtype": "bfloat16"}))
    # BASELINE config 3 and config 2, as the root bench adds them: not beside
    # a window batch, and not with UVHAND_BENCH_EXTRA_MODES=0
    if env("UVHAND_BENCH_EXTRA_MODES", "1") == "1" and not window:
        w32_meta = {"dtype": "bfloat16", "mode": "window32", "window": 32,
                    "split_window": split}

        def window32(metric):
            w32 = Bench(args, device, batch_size, steps, model_name, backbone, 32, split,
                        temporal, **knobs)
            w32_meta.update(batch=w32.frames, remat=w32.remat, temporal_head=w32.temporal)
            return train_line(torch.bfloat16, on=w32)(metric)

        extras.append(("train_frames_per_sec_chip_window32", window32, w32_meta))
        swin = copy.copy(bench)
        swin.backbone = "swin_L_384_22k"
        extras.append(("train_frames_per_sec_chip_swin", train_line(torch.bfloat16, on=swin),
                       {"dtype": "bfloat16", "mode": "swin_L_384_22k",
                        "backbone": swin.backbone}))
    if infer:
        extras.append(("infer_frames_per_sec_chip_fp32", infer_line(torch.float32),
                       {"dtype": "float32"}))
    for metric, fn, meta in extras:
        if metric.startswith("infer_") and not bench.serves:
            _emit({"metric": metric, "skipped": "the window batch keeps its centre frames' "
                   "cameras only (UVHAND_BENCH_SPLIT=0)"})
            continue
        if time.monotonic() - t_start >= budget_s:
            _emit({"metric": metric, "skipped": "budget",
                   "elapsed_s": time.monotonic() - t_start})
            continue
        try:
            emit_row(metric, fn, meta)
        except Exception as e:  # an extra must never cost the headline or the others
            traceback.print_exc()
            _emit({"metric": metric, "error": f"{type(e).__name__}: {e}"[:200]})


if __name__ == "__main__":
    main()
