"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. card: name and power limit (nvidia-smi), torch/CUDA versions, TF32 off,
     whether the host has what the native image library needs (g++, the
     OpenCV 4 and libjpeg headers);
  2. build: compiles the kernels (csrc/msda_fwd.cu, csrc/msda_bwd.cu,
     csrc/msda_fac_fwd.cu, csrc/msda_fac_bwd.cu, and the research kernels
     csrc/msda_onlyg.cu, csrc/msda_xdot.cu, csrc/probe_lane_slice.cu,
     csrc/probe_gather.cu), one nvcc per source, started together, and
     prints each kernel's registers, static shared memory and spills
     (`-Xptxas -v`);
  3. forward kernels against their plain version (`ms_deform_attn_torch`)
     at the serving path's encoder and decoder shapes in float32 and
     bfloat16, and at an out-of-range-heavy, an odd-D, a >128-side case and
     one case each just inside and just outside the shared-memory limit:
     the staged kernel wherever the shapes have a staged plan and the
     general kernel on every case, both exact in float32; times both in
     turns at the four model shapes, the plain version, the bound and a
     per-level `F.grid_sample` composition (a yardstick only; the port
     never calls it);
  3b. backward kernels against their plain version
     (`ms_deform_attn_torch_backward`) on the same kinds of cases plus an
     integer-exact one (every sample on a tent's kink), float32 and
     bfloat16, a >128 side in both, staged and general as in 3; times them
     like the forward, with the grid_sample composition's autograd backward
     as the yardstick;
  3c. the factorized kernels (csrc/msda_fac_fwd.cu, csrc/msda_fac_bwd.cu),
     the staged one wherever the shapes have a staged plan and the general
     one on every case, against their plain versions on the same kinds of
     cases plus a side of one and a side of 128: forward, dattn and dloc
     bit-identical, dvalue within TOL; held against the gather kernels on
     the same inputs (TOL); timed like 3 and 3b, with the grid_sample
     composition and its autograd backward as the yardstick;
  3d. the research entry points (`uvhand_tpu_torch/scripts/`), the slice's
     own path, counts from 0: the MSDA ablation bench's timing mode times
     every variant of the TPU bench in bf16 and float32 at its shapes
     (B=16, M=8, D=32, Lq=S=1045), each against its plain version (the
     ablation backward `msda_ablate_bwd`, the dense `msda_onlyg`, the
     `xdot` variant with `msda_xdot`, and the design variants through the
     landed kernels), and the lane-slice and gather probes hold both
     kinds of their kernels bit for bit against the probes' numpy
     expressions and time them in turns (vec4 and general at the probe's
     Q = 1048 and at the MSDA call site's Q = 16 x 1048, beside an empty
     kernel on vec4's grid, the launch floor; staged and general at every
     gather case along the last axis, the general kernel alone along the
     other; device time from the profiler) beside `torch.mul` /
     `torch.gather`, and print their kernels' ptxas lines; each kernel's
     launches must equal the calls the entry points made, by kind, and
     the phase's wall clock is logged. Then the bench's
     --check mode holds every variant's kernel against its plain version at
     the TPU check shapes in float32 and bf16 (launches checked, not
     counted), and its --kinds mode times the tiled and the general
     `msda_onlyg` kernel in turns on the same inputs at the bench shapes,
     and the `msda_xdot` kernel alone, in bf16 and float32 (CUDA events and
     profiler device time), each against its plain version (launches
     checked, not counted). The path itself must launch only the tiled
     onlyg kernel, 0 general. Every model path below must launch none of
     the research kernels; at these shapes every gather op runs its staged
     kernel;
  3e. each op's general path: `ms_deform_attn` and its backward on a
     64x64 float32 level (beyond shared memory) launch the general
     kernels once each and agree with the plain versions, in the gather
     form and under UVHAND_MSDA_FAC=1 (the factorized dattn and dloc bit
     for bit);
  3f. inputs the kernels do not take as they are -- a misaligned or
     transposed value, bf16 locations, strided attention, bf16 attention
     with a float32 value -- through `ms_deform_attn` and its backward in
     both forms and both types: each equals the plain version on the same
     inputs and runs the staged kernels; then a float16 and a float64
     value and a bfloat16 or float16 value with float32 attention, both
     forms: each equals the plain version (forward, dloc, dattn bit for bit;
     dvalue within TOL) through the kernels `TYPED` names (the factorized
     form's and float64's general kernels);
  4. serving path: `UVHandDETR` at full width (ResNet-50, 224x224, d=256,
     6+6 layers, 300 queries, 4 levels x 4 points, two-stage, box refine,
     float32) with seeded random weights serves three batches of 16
     synthetic frames through `engine.make_eval_step`; the forward's
     launch count must rise by exactly 12 per batch, all of them the staged
     kernel's, the backward's not at all;
  5. the same batch with the plain MSDA version must give the same outputs
     and metric rows;
  6. profile: host-clock times of the serving stages of one batch, and a
     torch.profiler table of its device kernels with the device's busy share;
  7. train, kernel against plain: one loss and backward of the same model in
     train mode from the same weights and generator seed with the kernels
     and with the plain MSDA versions; loss terms and every gradient agree;
  8. training path: `engine.make_fused_train_step` (dropout 0.1, feature mask
     0.3, AdamW lr 2e-4 / backbone 2e-5, clip 0.1) takes 2 steps on batches
     of 16 synthetic frames; per step every loss is finite, grad_norm is
     finite and > 0, the forward's and the backward's launch counts rise by
     exactly 12 each (all staged, none general) and the parameters of every
     group move;
  9. train profile: host-clock times of the train stages of one step, and a
     torch.profiler table of one step with the device's busy share;
  10. bf16 serving: the same model with `compute_dtype=torch.bfloat16` serves
     3 batches; msda_fwd rises by exactly 12 per batch, no other kernel;
  11. bf16 training: 4 steps, msda_fwd and msda_bwd each +12 per step (the
     backward kernel's bf16 regime, the JAX package's K2), with the checks
     of 8, and a kernel-against-plain train pass as 7;
  12. UVHAND_MSDA_FAC=1: the bf16 serving and training paths again, through
     the factorized kernels (msda_fac_fwd +12 per batch, +12 per step with
     msda_fac_bwd, all of them the staged kernels'; the general factorized
     and the gather kernels +0), serving outputs with the kernels equal to
     those with the plain versions, and one float32 batch (12 staged
     msda_fac_fwd) equal to phase 5's gather-kernel run (1e-4);
  with profile lines (device busy share, kernels, MSDA device ms) for one
  bf16 serving batch and one bf16 train step under each formulation;
  13. the port's CLI (`python -m uvhand_tpu_torch.cli.main`, called as
     `cli.main.main`) at full width on a synthetic ARCTIC root written
     under build/cli_smoke/ (68 frames, a contact window for MDev): the
     loader alone (frames/s; its CUDA prefetch equal to the host batches
     bit for bit), an fp32 epoch of 4 steps with its eval, `--eval
     --resume out/0` with the default metrics (the sequence pass
     included), and a `--bf16` epoch of 2 steps under UVHAND_MSDA_FAC=1;
     12 staged forward launches a batch, 12 + 12 a step, no other kernel;
     the resumed eval equal to the in-process one; every score finite; then
     the CLI's default single-stage model with `--enc_lite --remat` and
     `--two_stage --with_box_refine --bf16_params --sgd`, each an epoch of
     2 steps (24 + 12 launches a step under remat) and a `--resume` eval
     equal to its in-process one;
  14. each model and training option at full width, its depth cut to 6
     encoder and 2 decoder layers: single-stage (learned queries, 2-d
     references), learned position encoding, no-aux, enc_lite (hi_every 3
     and 6: the low-resolution-only layers' calls take 261 queries against
     1045 tokens, through the staged kernels), remat, bf16 parameters with
     stochastic rounding, SGD: 2 serving batches (8 staged forward launches
     each) held end to end against the plain MSDA run, 2 train steps with
     exact launches (remat: 16 forward + 8 backward a step; bf16 parameters
     stay bf16 and finite), and the device's busy share of a profiled batch
     and step;
  15. peak device memory of a full-width fp32 train step with and without
     remat at B=16 and B=32;
  16. the CLI as a multi-process user launches it, at world size 1 (one
     card; NCCL runs one rank a device): `python -m torch.distributed.run
     --standalone --nproc_per_node 1 -m uvhand_tpu_torch.cli.main` on phase
     13's root, an fp32 `--debug` epoch of 2 steps and its eval, then
     `--eval --resume`: an NCCL process group of one process, 12 staged
     forward launches a batch and 12 + 12 a step and no other kernel (each
     launched process writes its counts when it exits), one writer and
     one checkpoint, the epoch's losses within 1e-4 of the same flags run
     in this process without the launcher (its second step starts from
     other last bits: atomics), the epoch's scores equal bit for bit to the
     launched resumed eval's and to this process's eval of the checkpoint;
  17. the port's bench (`python -m uvhand_tpu_torch.bench`, a few steps a
     mode): its first line the bf16 train headline, finite and > 0, every
     other line a rate (the Swin-L train line too), 12 staged forward
     launches a call and 12 backward a train step; its lines logged beside
     the card;
  18. DINO_4scale at full width (`dino_variant`, `use_dn`,
     look-forward-twice, dn_number 100: the decoder's calls of a train step
     take 300 + 198 CDN queries), float32 and bf16: 2 serving batches (12
     staged forward launches each) held end to end against the plain MSDA
     run, a train pass against the plain versions with one injected CDN
     draw (every loss, the `*_dn` terms included, within 1e-4; gradients
     within 1e-3 / 5e-2 of each tensor's max), 3 train steps (12 + 12
     staged launches a step, no other kernel, `label_enc` moves), the
     steady step ms and a profiled step's device busy share;
  19. the DINO model on ConvNeXt-XL, float32: one serving batch and 2
     train steps with the same launch checks, and their peak device
     memory; then the CLI with `--modelname dino` on phase 13's root: an
     epoch of 2 steps and its eval, and `--eval --resume` of its checkpoint,
     whose scores must equal the in-process eval's;
  20. the temporal variant at full width: arctic_sf with the lstm head on
     windows of 32 frames with every frame's targets (`split_window`) and
     with the vivit head on the centre frames' targets (`center_index`),
     float32 and bf16, one `TempoTrainDataset` window a step from a
     synthetic root of 54 frames: a train pass against the plain MSDA
     versions (every loss, the `/temporal` terms included, within 1e-4;
     gradients within 1e-3 / 5e-2 of each tensor's max), 3 train steps
     (12 + 12 staged launches a step, no other kernel; the steady step ms,
     frames/s and peak memory, remat off and for lstm on: 24 + 12), 2
     serving windows of the fp32 lstm model (12 a batch, held end to end
     against the plain run; its metrics from the refined parameters) and a
     profiled step; 3 SmoothNet steps (`ArcticSmoother(32)` behind a frozen
     fp32 arctic_sf: 12 forward and no backward launches a step, the base
     bit-identical, the smoother moved); then the CLI on phase 13's root
     with window 3: `--method arctic_lstm --temporal_head lstm` (an epoch of
     2 steps and its eval, `--eval --resume` with equal scores),
     `--train_smoothnet` (2 steps) and `--smooth_resume` of its smoother;
  21. arctic_sf on the Swin-L backbone (`swin_L_384_22k`) at full width,
     float32 and bf16: 2 serving batches (12 staged forward launches each)
     held end to end against the plain MSDA run, a train pass against the
     plain versions (losses within 1e-4; gradients within 1e-3 / 5e-2 of
     each tensor's max), 3 train steps (12 + 12 staged launches a step, no
     other kernel; the steady step ms, frames/s and peak memory), one step
     with remat on (24 + 12) and its peak, a profiled step's busy share;
     then the CLI with `--backbone swin_L_384_22k` on phase 13's root: an
     epoch of 2 steps and its eval, and `--eval --resume` with equal scores;
  22. the AssemblyHands model (`AssemblyDETR`: R50, 224x224, d=256, 6+6
     layers, 3 queries, float32) on batches of 16 from a synthetic COCO
     root: 2 serving batches (12 staged forward launches each, the decoder's
     6 at Lq 3) held end to end against the plain MSDA run, a train pass
     against the plain versions (every criterion term within 1e-4,
     gradients within 1e-3 of each tensor's max), 3 train steps (12 + 12
     staged launches a step, no other kernel; step ms, frames/s, peak
     memory) and profiled lines; then the CLI with `--dataset_file
     AssemblyHands` and with `H2O`: an epoch of 2 steps, its checkpoint and
     eval, and `--eval --resume` with equal scores.
  23. the export routes on phase 13's root with its fp32 checkpoint, at
     full width: the CLI's `--extraction_mode submit_pose` (the ARCTIC
     submission of the val split, 12 staged forward launches a batch of 16
     and no other kernel, every file float16 and finite), the same export
     by `run_extraction` in this process with the kernels and with the
     plain MSDA versions (values before the float16 cast within 1e-4 of
     each tensor's max; the CLI's files equal the kernel run's bit for
     bit), the CLI's `--extract` (the backbone's maps, no MSDA launch) and a
     `local_fm` model fed the stored maps of 16 frames (3 levels, S = 1029:
     12 staged launches a batch, outputs within 1e-4 of its plain run's),
     and `--eval --visualization` (32 frames in batches of 4, a PNG each,
     the OBJ meshes of the first 4).
  Phases 3 and 3b also time the forward and backward kernels on one
  enc_lite call (Lq 261, S 1045, B=16, float32), on one DINO decoder
  call (Lq 498, float32 and bf16), on one encoder call of the temporal
  train step (B=32 frames, float32) and on one AssemblyHands decoder call
  (Lq 3, S 1045, B=16, float32) beside their bounds; phase 3 also times the
  forward kernels on one encoder call of the local_fm model (3 levels, Lq =
  S = 1029, B=16, float32).

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}; the
line before it is the card's name and power limit, and the one before that
gives every ported kernel's numbers as JSON.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from uvhand_tpu_torch import engine
from uvhand_tpu_torch.cli import main as cli
from uvhand_tpu_torch.data import arctic
from uvhand_tpu_torch.data.loader import DataLoader, device_prefetch
from uvhand_tpu_torch.geometry import mano, objects
from uvhand_tpu_torch.geometry.rotations import axis_angle_to_matrix, rotate_about_axis
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.models.dn import CdnConfig, prepare_cdn
from uvhand_tpu_torch.ops import msda_cuda
from uvhand_tpu_torch.ops.msda import (MSDeformAttn, ms_deform_attn, ms_deform_attn_fac_torch,
                                       ms_deform_attn_fac_torch_backward, ms_deform_attn_torch,
                                       ms_deform_attn_torch_backward)
from uvhand_tpu_torch.scripts import bench_msda_ablation, probe_dynamic_lane_slice, probe_gather
from uvhand_tpu_torch.scripts.measure import device_ms, median_ms, msda_bound_ms, msda_bwd_bound_ms
from uvhand_tpu_torch.train.state import create_optimizer, label_params

SEED = 0
BATCH = 16
IMG_RES = 224
N_BATCHES = 3
TRAIN_STEPS = 4
FP32_TRAIN_STEPS = 2  # fewer float32 steps, to leave time for the bf16 and FAC paths
MSDA_PER_FORWARD = 12  # 6 encoder self-attention + 6 decoder cross-attention
# level shapes of a 224x224 image: strides 8, 16, 32 and the extra stride-64 level
LEVELS = ((28, 28), (14, 14), (7, 7), (4, 4))
# enc_lite's low-resolution-only layers: the queries of levels 1.. (S - 28*28)
ENC_LITE_LQ = sum(h * w for h, w in LEVELS[1:])
#: a precomputed-feature (local_fm) model's levels: the backbone's 3 maps, no extra level
LOCAL_FM_LEVELS = LEVELS[:3]
# the DINO train step's decoder call: 300 matching + 198 CDN queries (dn_number 100)
DN_LQ = 300 + CdnConfig(100).pad_size
# the temporal variant's window: a train step runs the model on its 32 frames
TEMPORAL_WINDOW = 32
# relative to max|value| (forward) or to each gradient's max (backward: the
# float32 dvalue is summed by atomics in no fixed order)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3, torch.float64: 1e-12}
KEYS = ("pred_logits", "pred_hand_key", "pred_obj_key")  # the outputs held end to end
#: the ops whose wrappers pick a staged (onlyg: tiled; the lane slice: vec4)
#: or a general kernel, and the counts of each kernel's launches
VARIANTS = {
    "msda_fwd": {"staged": msda_cuda.FWD_STAGED, "general": msda_cuda.FWD_GENERAL},
    "msda_bwd": {"staged": msda_cuda.BWD_STAGED, "general": msda_cuda.BWD_GENERAL},
    "msda_fac_fwd": {"staged": msda_cuda.FAC_FWD_STAGED, "general": msda_cuda.FAC_FWD_GENERAL},
    "msda_fac_bwd": {"staged": msda_cuda.FAC_BWD_STAGED, "general": msda_cuda.FAC_BWD_GENERAL},
    "msda_ablate_bwd": {"staged": msda_cuda.ABLATE_STAGED, "general": msda_cuda.ABLATE_GENERAL},
    "msda_onlyg": {"tiled": msda_cuda.ONLYG_TILED, "general": msda_cuda.ONLYG_GENERAL},
    "probe_lane_slice": {"vec4": msda_cuda.LANE_VEC4, "general": msda_cuda.LANE_GENERAL},
    "probe_gather": {"staged": msda_cuda.GATHER_STAGED, "general": msda_cuda.GATHER_GENERAL},
}
#: every kernel's launch count by name (the wrappers' counts and, for the
#: VARIANTS ops, each kernel's: `<op>_<kind>`)
KERNELS = msda_cuda.COUNTS


def log(*args):
    print(*args, flush=True)


# ------------------------------------------------------------ 3. kernel


def msda_inputs(gen, B, Lq, M, D, P, shapes, lo, hi, dtype):
    """Random MSDA inputs; lo == hi == None puts every sample on an exact
    pixel centre (the shapes must be powers of two to make that exact)."""
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    dev = "cuda"
    value = torch.randn(B, S, M, D, generator=gen, device=dev).to(dtype)
    u = torch.rand(B, Lq, M, L, P, 2, generator=gen, device=dev)
    if lo is None:
        size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)
        loc = (torch.floor(u * size[:, None, :]) + 0.5) / size[:, None, :]
    else:
        loc = lo + (hi - lo) * u
    attn = torch.randn(B, Lq, M, L * P, generator=gen, device=dev).softmax(-1)
    return value, loc, attn.view(B, Lq, M, L, P).to(dtype)


def grid_sample_msda(value, shapes, loc, attn):
    """The reference's pure-PyTorch MSDA formula, one grid_sample per level."""
    B, S, M, D = value.shape
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    grids = 2 * loc - 1
    out = 0
    start = 0
    for lvl, (H, W) in enumerate(shapes):
        v = value[:, start:start + H * W].permute(0, 2, 3, 1).reshape(B * M, D, H, W)
        g = grids[:, :, :, lvl].transpose(1, 2).reshape(B * M, Lq, P, 2)
        s = F.grid_sample(v, g.to(v.dtype), mode="bilinear", padding_mode="zeros",
                          align_corners=False)  # (B*M, D, Lq, P)
        a = attn[:, :, :, lvl].transpose(1, 2).reshape(B * M, 1, Lq, P)
        out = out + (s * a).sum(-1)
        start += H * W
    return out.view(B, M, D, Lq).permute(0, 3, 1, 2).reshape(B, Lq, M * D)


def ptxas_lines(report):
    """One line per kernel from the compiler's `-Xptxas -v` report: its
    registers, static shared memory, stack and spills (the staged kernels'
    shared memory is dynamic: their plan's bytes, printed by phases 3, 3b)."""
    import re

    entries, name, frame = [], None, ""
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name, frame = m.group(1), ""
        elif "bytes stack frame" in line:
            frame = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            entries.append((name, f"{m.group(1)} registers, "
                                  f"{smem.group(1) if smem else 0} bytes static smem; {frame}"))
            name = None
    if not entries:
        return ["ptxas: no report (the library was built earlier)"]
    names = [n for n, _ in entries]
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True).stdout.splitlines()
    return [f"ptxas {n}: {info}" for n, (_, info) in zip(names, entries)]


def timing_line(times):
    """The staged and general kernels' times of one case for a log line."""
    return ", ".join(f"{kind} {t['ms']:.4f} ms (device {ms_or_not(t['device_ms'])})"
                     for kind, t in times.items()) + (
        " (ms: the lower of two CUDA-event medians, in turns general, staged, staged, general; "
        "device: the profiler's device time a call)")


def ms_or_not(ms):
    """A device time for a log line, or "not measured" where the profiler
    saw no device work."""
    return "not measured" if ms is None else f"{ms:.4f}"


def kernels_of(plan):
    """The kernels of an op to hold against the plain version on a case: the
    staged one where the shapes have a plan, and the general one always."""
    return ("staged", "general") if plan is not None else ("general",)


#: one case each just inside and just outside the shared-memory limit
#: (msda_cuda.SMEM_LIMIT = 232,448 bytes): a block stages 1816 float32 rows
#: of 32 channels at most, the forward's whole slab or the backward's level
EDGE = [("smem edge inside fp32", dict(B=2, Lq=200, M=8, D=32, P=4, shapes=((8, 227),)),
         (-0.1, 1.1), torch.float32, False),
        ("smem edge outside fp32", dict(B=2, Lq=200, M=8, D=32, P=4, shapes=((8, 228),)),
         (-0.1, 1.1), torch.float32, False)]


def kernel_phase():
    """The forward kernels against `ms_deform_attn_torch`: the staged one
    (where the shapes have a plan) and the general one on every case, each
    timed at the four model shapes in the same run. Returns
    ({case: {kernel: numbers}}, {kernel: largest float32 error})."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    enc = dict(B=BATCH, Lq=sum(h * w for h, w in LEVELS), M=8, D=32, P=4, shapes=LEVELS)
    dec = dict(enc, Lq=300)
    cases = [
        # name, shape, loc range, dtype, timed
        ("encoder fp32", enc, (0.0, 1.0), torch.float32, True),
        ("decoder fp32", dec, (-1.0, 1.0), torch.float32, True),
        ("enc_lite fp32", dict(enc, Lq=ENC_LITE_LQ), (0.0, 1.0), torch.float32, True),
        ("encoder bf16", enc, (0.0, 1.0), torch.bfloat16, True),
        ("decoder bf16", dec, (-1.0, 1.0), torch.bfloat16, True),
        ("dn decoder fp32", dict(enc, Lq=DN_LQ), (-1.0, 1.0), torch.float32, True),
        ("dn decoder bf16", dict(enc, Lq=DN_LQ), (-1.0, 1.0), torch.bfloat16, True),
        ("temporal encoder fp32", dict(enc, B=TEMPORAL_WINDOW), (0.0, 1.0), torch.float32, True),
        ("assembly decoder fp32", dict(enc, Lq=ASSEMBLY_LQ), (-0.5, 1.5), torch.float32, True),
        ("local_fm encoder fp32", dict(enc, Lq=sum(h * w for h, w in LOCAL_FM_LEVELS),
                                       shapes=LOCAL_FM_LEVELS), (0.0, 1.0), torch.float32, True),
        ("out-of-range fp32", dec, (-2.0, 3.0), torch.float32, False),
        ("odd D=71 fp32", dict(B=2, Lq=100, M=4, D=71, P=4, shapes=LEVELS[:2]),
         (-0.2, 1.2), torch.float32, False),
        ("odd D=30 bf16", dict(B=2, Lq=100, M=4, D=30, P=2, shapes=LEVELS),
         (-0.2, 1.2), torch.bfloat16, False),
        ("side>128 fp32", dict(B=2, Lq=200, M=8, D=32, P=4, shapes=((4, 200), (150, 3))),
         (-0.1, 1.1), torch.float32, False),
        *EDGE,
    ]
    timed = {}
    log("[kernel] forward (csrc/msda_fwd.cu: staged and general) against ms_deform_attn_torch")
    max_err = {"staged": 0.0, "general": 0.0}
    for name, shape, (lo, hi), dtype, is_timed in cases:
        shp = dict(shape)
        shapes = shp.pop("shapes")
        value, loc, attn = msda_inputs(gen, **shp, shapes=shapes, lo=lo, hi=hi, dtype=dtype)
        plan = msda_cuda.staged_plan(shapes, shp["D"], dtype)
        ref = ms_deform_attn_torch(value, shapes, loc, attn)
        for kind in kernels_of(plan):
            out = msda_cuda.ms_deform_attn_cuda(value, shapes, loc, attn, kernel=kind)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            rel = err / float(value.float().abs().max())
            # float32: both kernels repeat the plain version's order exactly
            ok = (bool(torch.isfinite(out.float()).all())
                  and (err == 0.0 if dtype == torch.float32 else rel <= TOL[dtype]))
            log(f"[kernel] {name} {kind}: max_abs_err={err:.3e} rel={rel:.3e} "
                f"{'(must be 0)' if dtype == torch.float32 else f'tol={TOL[dtype]:.0e}'} "
                f"{'ok' if ok else 'FAIL'}"
                + (f" (plan: {plan.smem} B of shared memory)" if kind == "staged" else ""))
            if not ok:
                raise AssertionError(f"MSDA {kind} kernel disagrees with its plain version "
                                     f"({name})")
            if dtype == torch.float32:
                max_err[kind] = max(max_err[kind], err)
        if plan is None and name.startswith(("encoder", "decoder", "enc_lite", "dn decoder",
                                             "temporal", "assembly", "local_fm")):
            raise AssertionError(f"arctic_sf's shapes must have a staged plan ({name})")
        if not is_timed:
            continue
        bound, bound_by = msda_bound_ms(value, shapes, loc, attn)
        timed[name] = {}
        for kind in ("general", "staged", "staged", "general"):  # in turns, on one card
            ms = median_ms(lambda: msda_cuda.ms_deform_attn_cuda(value, shapes, loc, attn,
                                                                 kernel=kind))
            timed[name].setdefault(kind, []).append(ms)
        plain = median_ms(lambda: ms_deform_attn_torch(value, shapes, loc, attn), iters=5)
        for kind in ("staged", "general"):
            dev = device_ms(lambda: msda_cuda.ms_deform_attn_cuda(value, shapes, loc, attn,
                                                                  kernel=kind))
            timed[name][kind] = dict(ms=min(timed[name][kind]), device_ms=dev, plain_ms=plain,
                                     bound_ms=bound, bound_by=bound_by)
        log(f"[kernel] {name}: {timing_line(timed[name])}, plain {plain:.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by})")
        if dtype == torch.float32:
            gs_err = float((grid_sample_msda(value, shapes, loc, attn) - ref).abs().max())
            gs = median_ms(lambda: grid_sample_msda(value, shapes, loc, attn))
            log(f"[kernel] {name}: per-level grid_sample composition (yardstick only, "
                f"not one library call) {gs:.4f} ms, max_abs_err {gs_err:.2e}")
    return timed, max_err


def backward_kernel_phase():
    """The backward kernels against `ms_deform_attn_torch_backward`: the
    staged one (where the shapes have a plan) and the general one on every
    case, every gradient within TOL of its own max; each timed at the four
    model shapes in the same run."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    enc = dict(B=BATCH, Lq=sum(h * w for h, w in LEVELS), M=8, D=32, P=4, shapes=LEVELS)
    dec = dict(enc, Lq=300)
    side = dict(B=2, Lq=200, M=8, D=32, P=4, shapes=((4, 200), (150, 3)))
    exact = dict(B=2, Lq=300, M=8, D=32, P=4, shapes=((16, 32), (8, 16), (4, 8), (2, 4)))
    cases = [
        ("encoder fp32", enc, (0.0, 1.0), torch.float32, True),
        ("decoder fp32", dec, (-1.0, 1.0), torch.float32, True),
        ("enc_lite fp32", dict(enc, Lq=ENC_LITE_LQ), (0.0, 1.0), torch.float32, True),
        ("encoder bf16", enc, (0.0, 1.0), torch.bfloat16, True),
        ("decoder bf16", dec, (-1.0, 1.0), torch.bfloat16, True),
        ("dn decoder fp32", dict(enc, Lq=DN_LQ), (-1.0, 1.0), torch.float32, True),
        ("dn decoder bf16", dict(enc, Lq=DN_LQ), (-1.0, 1.0), torch.bfloat16, True),
        ("temporal encoder fp32", dict(enc, B=TEMPORAL_WINDOW), (0.0, 1.0), torch.float32, True),
        ("assembly decoder fp32", dict(enc, Lq=ASSEMBLY_LQ), (-0.5, 1.5), torch.float32, True),
        ("out-of-range fp32", dec, (-2.0, 3.0), torch.float32, False),
        ("odd D=71 fp32", dict(B=2, Lq=100, M=4, D=71, P=4, shapes=LEVELS[:2]),
         (-0.2, 1.2), torch.float32, False),
        ("odd D=30 bf16", dict(B=2, Lq=100, M=4, D=30, P=2, shapes=LEVELS),
         (-0.2, 1.2), torch.bfloat16, False),
        ("side>128 fp32", side, (-0.1, 1.1), torch.float32, False),
        ("side>128 bf16", side, (-0.1, 1.1), torch.bfloat16, False),
        ("integer-exact fp32", exact, (None, None), torch.float32, False),
        ("integer-exact bf16", exact, (None, None), torch.bfloat16, False),
        *EDGE,
    ]
    log("[bwd] backward (csrc/msda_bwd.cu: staged and general) against "
        "ms_deform_attn_torch_backward")
    timed, max_err = {}, {"staged": 0.0, "general": 0.0}
    bwd = msda_cuda.ms_deform_attn_backward_cuda
    for name, shape, (lo, hi), dtype, is_timed in cases:
        shp = dict(shape)
        shapes = shp.pop("shapes")
        value, loc, attn = msda_inputs(gen, **shp, shapes=shapes, lo=lo, hi=hi, dtype=dtype)
        grad = torch.randn(shp["B"], shp["Lq"], shp["M"] * shp["D"], generator=gen,
                           device="cuda").to(dtype)
        plan = msda_cuda.staged_plan(shapes, shp["D"], dtype, backward=True)
        ref = ms_deform_attn_torch_backward(value, shapes, loc, attn, grad)
        for kind in kernels_of(plan):
            ours = bwd(value, shapes, loc, attn, grad, kernel=kind)
            torch.cuda.synchronize()
            errs = []
            for gname, o, r in zip(("dvalue", "dloc", "dattn"), ours, ref):
                err = float((o.float() - r.float()).abs().max())
                rel = err / max(float(r.float().abs().max()), 1e-30)
                ok = (bool(torch.isfinite(o.float()).all()) and o.dtype == r.dtype
                      and rel <= TOL[dtype])
                errs.append(f"{gname} {err:.3e} (rel {rel:.2e})")
                if not ok:
                    raise AssertionError(f"MSDA {kind} backward kernel disagrees with its plain "
                                         f"version ({name}, {gname}: rel {rel:.3e})")
                if dtype == torch.float32:
                    max_err[kind] = max(max_err[kind], err)
            log(f"[bwd] {name} {kind}: max_abs_err " + ", ".join(errs)
                + f"; tol {TOL[dtype]:.0e} ok"
                + (f" (plan: levels {plan.groups}, {plan.smem} B of shared memory)"
                   if kind == "staged" else ""))
        if plan is None and name.startswith(("encoder", "decoder", "enc_lite", "dn decoder",
                                             "temporal", "assembly")):
            raise AssertionError(f"arctic_sf's shapes must have a staged plan ({name})")
        if not is_timed:
            continue
        bound, bound_by = msda_bwd_bound_ms(value, shapes, loc, attn, grad)
        timed[name] = {}
        for kind in ("general", "staged", "staged", "general"):  # in turns, on one card
            ms = median_ms(lambda: bwd(value, shapes, loc, attn, grad, kernel=kind))
            timed[name].setdefault(kind, []).append(ms)
        plain = median_ms(lambda: ms_deform_attn_torch_backward(value, shapes, loc, attn, grad),
                          iters=5)
        for kind in ("staged", "general"):
            dev = device_ms(lambda: bwd(value, shapes, loc, attn, grad, kernel=kind))
            timed[name][kind] = dict(ms=min(timed[name][kind]), device_ms=dev, plain_ms=plain,
                                     bound_ms=bound, bound_by=bound_by)
        log(f"[bwd] {name}: {timing_line(timed[name])}, plain {plain:.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by})")
        if dtype == torch.float32:
            leaves = [t.clone().requires_grad_() for t in (value, loc, attn)]
            out = grid_sample_msda(leaves[0], shapes, leaves[1], leaves[2])
            gs = median_ms(lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True))
            log(f"[bwd] {name}: per-level grid_sample composition's autograd backward "
                f"(yardstick only, not one library call) {gs:.4f} ms")
    return timed, max_err


def fac_kernel_phase():
    """The factorized kernels, the staged one (where the shapes have a plan)
    and the general one on every case, against their plain versions
    (forward, dattn and dloc bit-identical, dvalue within TOL) and against
    the gather kernels on the same inputs (TOL: two formulations of one
    function); each timed at the four model shapes in turns in the same run.
    Returns ({"fwd"|"bwd": {case: {kernel: numbers}}}, {"fwd"|"bwd":
    {kernel: largest float32 error}})."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    enc = dict(B=BATCH, Lq=sum(h * w for h, w in LEVELS), M=8, D=32, P=4, shapes=LEVELS)
    dec = dict(enc, Lq=300)
    exact = dict(B=2, Lq=300, M=8, D=32, P=4, shapes=((16, 32), (8, 16), (4, 8), (2, 4)))
    one = dict(B=2, Lq=200, M=8, D=32, P=4, shapes=((6, 5), (2, 1), (1, 1)))
    side = dict(B=2, Lq=200, M=8, D=32, P=4, shapes=((128, 4), (64, 2)))
    cases = [
        ("encoder fp32", enc, (0.0, 1.0), torch.float32, True),
        ("decoder fp32", dec, (-1.0, 1.0), torch.float32, True),
        ("encoder bf16", enc, (0.0, 1.0), torch.bfloat16, True),
        ("decoder bf16", dec, (-1.0, 1.0), torch.bfloat16, True),
        ("out-of-range fp32", dec, (-2.0, 3.0), torch.float32, False),
        ("out-of-range bf16", dec, (-2.0, 3.0), torch.bfloat16, False),
        ("odd D=71 fp32", dict(B=2, Lq=100, M=4, D=71, P=4, shapes=LEVELS[:2]),
         (-0.2, 1.2), torch.float32, False),
        ("odd D=30 bf16", dict(B=2, Lq=100, M=4, D=30, P=2, shapes=LEVELS),
         (-0.2, 1.2), torch.bfloat16, False),
        ("side of one fp32", one, (0.0, 1.0), torch.float32, False),
        ("side of one bf16", one, (0.0, 1.0), torch.bfloat16, False),
        ("side of 128 fp32", side, (-0.1, 1.1), torch.float32, False),
        ("integer-exact fp32", exact, (None, None), torch.float32, False),
        ("integer-exact bf16", exact, (None, None), torch.bfloat16, False),
    ]
    log("[fac] factorized kernels (csrc/msda_fac_fwd.cu, msda_fac_bwd.cu: staged and general) "
        "against ms_deform_attn_fac_torch(_backward), and against the gather kernels")
    fwd, bwd = msda_cuda.ms_deform_attn_fac_cuda, msda_cuda.ms_deform_attn_fac_backward_cuda
    timed = {"fwd": {}, "bwd": {}}
    max_err = {key: {"staged": 0.0, "general": 0.0} for key in timed}
    for name, shape, (lo, hi), dtype, is_timed in cases:
        shp = dict(shape)
        shapes = shp.pop("shapes")
        value, loc, attn = msda_inputs(gen, **shp, shapes=shapes, lo=lo, hi=hi, dtype=dtype)
        grad = torch.randn(shp["B"], shp["Lq"], shp["M"] * shp["D"], generator=gen,
                           device="cuda").to(dtype)
        plan = msda_cuda.staged_plan(shapes, shp["D"], dtype)
        refs = (ms_deform_attn_fac_torch(value, shapes, loc, attn),
                *ms_deform_attn_fac_torch_backward(value, shapes, loc, attn, grad))
        gather = (msda_cuda.ms_deform_attn_cuda(value, shapes, loc, attn),
                  *msda_cuda.ms_deform_attn_backward_cuda(value, shapes, loc, attn, grad))
        for kind in kernels_of(plan):
            outs = (fwd(value, shapes, loc, attn, kernel=kind),
                    *bwd(value, shapes, loc, attn, grad, kernel=kind))
            torch.cuda.synchronize()
            report = []
            for gname, o, r, g in zip(("out", "dvalue", "dloc", "dattn"), outs, refs, gather):
                err = float((o.float() - r.float()).abs().max())
                scale = max(float(r.float().abs().max()), 1e-30)
                vs_gather = float((o.float() - g.float()).abs().max()) / scale
                exact_wanted = gname != "dvalue"
                ok = (bool(torch.isfinite(o.float()).all()) and o.dtype == r.dtype
                      and (err == 0.0 if exact_wanted else err / scale <= TOL[dtype])
                      and vs_gather <= TOL[dtype])
                report.append(f"{gname} {err:.3e} (vs gather {vs_gather:.2e})")
                if not ok:
                    raise AssertionError(
                        f"factorized {kind} kernel disagrees ({name}, {gname}): max_abs_err "
                        f"{err:.3e} "
                        f"{'(must be 0)' if exact_wanted else f'(rel tol {TOL[dtype]:.0e})'}, "
                        f"vs gather {vs_gather:.3e} of max (tol {TOL[dtype]:.0e})")
                if dtype == torch.float32:
                    key = "fwd" if gname == "out" else "bwd"
                    max_err[key][kind] = max(max_err[key][kind], err)
            log(f"[fac] {name} {kind}: max_abs_err vs plain " + ", ".join(report) + " ok"
                + (f" (plan: {plan.smem} B of shared memory forward, "
                   f"{msda_cuda.staged_plan(shapes, shp['D'], dtype, backward=True).smem} B "
                   f"backward)" if kind == "staged" else ""))
        if plan is None and name.startswith(("encoder", "decoder")):
            raise AssertionError(f"arctic_sf's shapes must have a staged plan ({name})")
        if not is_timed:
            continue
        for key, call, plain, bound in (
                ("fwd", lambda kind: fwd(value, shapes, loc, attn, kernel=kind),
                 lambda: ms_deform_attn_fac_torch(value, shapes, loc, attn),
                 msda_bound_ms(value, shapes, loc, attn)),
                ("bwd", lambda kind: bwd(value, shapes, loc, attn, grad, kernel=kind),
                 lambda: ms_deform_attn_fac_torch_backward(value, shapes, loc, attn, grad),
                 msda_bwd_bound_ms(value, shapes, loc, attn, grad))):
            t = timed[key][name] = {}
            for kind in ("general", "staged", "staged", "general"):  # in turns, on one card
                t.setdefault(kind, []).append(median_ms(lambda: call(kind)))
            plain_ms = median_ms(plain, iters=5)
            for kind in ("staged", "general"):
                t[kind] = dict(ms=min(t[kind]), device_ms=device_ms(lambda: call(kind)),
                               plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1])
            log(f"[fac] {name} {key}: {timing_line(t)}, plain {plain_ms:.4f} ms, bound "
                f"{bound[0]:.4f} ms ({bound[1]})")
        gs = median_ms(lambda: grid_sample_msda(value, shapes, loc, attn))
        leaves = [t.clone().requires_grad_() for t in (value, loc, attn)]
        out = grid_sample_msda(leaves[0], shapes, leaves[1], leaves[2])
        gs_bwd = median_ms(lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True))
        log(f"[fac] {name}: per-level grid_sample composition (yardstick only, not one "
            f"library call) forward {gs:.4f} ms, autograd backward {gs_bwd:.4f} ms")
    return timed, max_err


def general_path_phase(fac=False):
    """An op's general path: `ms_deform_attn` with a gradient on shapes
    whose slab exceeds shared memory (one 64x64 float32 level, a stride-8
    map of a 512x512 image; under UVHAND_MSDA_FAC=1 with `fac`, which
    `fac_ok` takes: side 64, WD 2048) runs the general kernels; forward and
    gradients held against the plain versions (the factorized dattn and
    dloc bit for bit). Counts from 0; returns the launches."""
    op = "msda_fac" if fac else "msda"
    tag = "[fac-general]" if fac else "[general]"
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    shapes = ((64, 64),)
    value, loc, attn = msda_inputs(gen, B=2, Lq=300, M=8, D=32, P=4, shapes=shapes, lo=0.0,
                                   hi=1.0, dtype=torch.float32)
    grad = torch.randn(2, 300, 8 * 32, generator=gen, device="cuda")
    if msda_cuda.staged_plan(shapes, 32, torch.float32) is not None:
        raise AssertionError("the general path's case must exceed shared memory")
    leaves = [t.clone().requires_grad_() for t in (value, loc, attn)]
    with fac_formulation() if fac else contextlib.nullcontext():
        reset_counts()
        out = ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
        out.backward(grad)
        torch.cuda.synchronize()
        counts = read_counts()
    want = expected({f"{op}_fwd": 1, f"{op}_bwd": 1, f"{op}_fwd_general": 1,
                     f"{op}_bwd_general": 1})
    log(f"{tag} 64x64 fp32 level through ms_deform_attn and its backward: launches "
        f"{json.dumps({n: c for n, c in counts.items() if c})}")
    if counts != want:
        raise AssertionError(f"{tag} general path: launches {counts}, expected {want}")
    plain_fwd, plain_bwd = ((ms_deform_attn_fac_torch, ms_deform_attn_fac_torch_backward) if fac
                            else (ms_deform_attn_torch, ms_deform_attn_torch_backward))
    ref = plain_fwd(value, shapes, loc, attn)
    refs = plain_bwd(value, shapes, loc, attn, grad)
    err = float((out.detach() - ref).abs().max())
    abs_errs = [float((t.grad - r).abs().max()) for t, r in zip(leaves, refs)]
    rels = [e / max(float(r.abs().max()), 1e-30) for e, r in zip(abs_errs, refs)]
    log(f"{tag} forward max_abs_err {err:.3e} (must be 0); dvalue, dloc, dattn "
        f"{', '.join(f'{r:.2e}' for r in rels)} of max (tol {TOL[torch.float32]:.0e}"
        f"{'; dloc and dattn must be 0' if fac else ''})")
    if err != 0.0 or max(rels) > TOL[torch.float32] or (fac and max(abs_errs[1:]) != 0.0):
        raise AssertionError(f"{tag} general path disagrees with the plain versions")
    return counts


#: inputs the kernels do not take as they are, which `ms_deform_attn` brings
#: into their form (`msda.kernel_inputs`) before the launch
UNPREPARED = {
    "misaligned value": lambda v, loc, a: (
        torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)[1:].view(v.shape).copy_(v),
        loc, a),
    "transposed value": lambda v, loc, a: (v.transpose(2, 3).contiguous().transpose(2, 3),
                                           loc, a),
    "bf16 locations": lambda v, loc, a: (v, loc.bfloat16(), a),
    "strided attention": lambda v, loc, a: (v, loc, torch.cat([a, a], -1)[..., :a.shape[-1]]),
    "fp32 value, bf16 attention": lambda v, loc, a: (v.float(), loc, a.bfloat16()),
}


#: value and attention types that not every kernel takes: (value type,
#: attention type, the kernel kind each form runs). The gather form widens
#: a float16 value, or a bfloat16 one with float32 attention, to float32 (the
#: staged kernels); float64, and every such case of the factorized form, runs
#: the general kernels
TYPED = {
    "fp16 value": (torch.float16, torch.float16, {"gather": "staged", "fac": "general"}),
    "fp64 value": (torch.float64, torch.float64, {"gather": "general", "fac": "general"}),
    "bf16 value, fp32 attention": (torch.bfloat16, torch.float32,
                                   {"gather": "staged", "fac": "general"}),
    "fp16 value, fp32 attention": (torch.float16, torch.float32,
                                   {"gather": "staged", "fac": "general"}),
}


def unprepared_inputs_phase():
    """The op on inputs the kernels do not take as they are (a misaligned or
    transposed value, bf16 locations, strided attention, attention of
    another type) and on the value types of TYPED (float16, float64, a
    bfloat16 or float16 value with float32 attention): forward and autograd
    backward of `ms_deform_attn` in both forms on the decoder's shapes
    (B=2), held against the plain versions on the same inputs -- forward,
    dloc and dattn bit for bit in float32 arithmetic and in the factorized
    form, else within TOL; dvalue within TOL -- each through the staged
    kernels (the preparation aligns the value) or, for TYPED, the kernels
    it names. Returns the launches."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    total = {name: 0 for name in KERNELS}
    for fac in (False, True):
        form = "fac" if fac else "gather"
        plain_fwd, plain_bwd = ((ms_deform_attn_fac_torch, ms_deform_attn_fac_torch_backward)
                                if fac else (ms_deform_attn_torch, ms_deform_attn_torch_backward))
        op = "msda_fac" if fac else "msda"
        cases = [(name, make, dtype, "staged") for dtype in (torch.float32, torch.bfloat16)
                 for name, make in UNPREPARED.items()]
        cases += [(name, lambda v, loc, a, vdt=vdt, adt=adt: (
            v.to(vdt), loc.to(torch.promote_types(vdt, torch.float32)), a.to(adt)),
            torch.float32, kinds[form]) for name, (vdt, adt, kinds) in TYPED.items()]
        for name, make, dtype, kind in cases:
            value, loc, attn = make(*msda_inputs(gen, B=2, Lq=300, M=8, D=32, P=4,
                                                 shapes=LEVELS, lo=-1.0, hi=1.0, dtype=dtype))
            grad = torch.randn(2, 300, 256, generator=gen, device="cuda").to(value.dtype)
            leaves = [t.detach().requires_grad_() for t in (value, loc, attn)]
            with fac_formulation() if fac else contextlib.nullcontext():
                reset_counts()
                out = ms_deform_attn(leaves[0], LEVELS, leaves[1], leaves[2])
                out.backward(grad)
                torch.cuda.synchronize()
                counts = read_counts()
            # bit for bit where the kernels compute the plain version's arithmetic:
            # float32 (a float16 value widened), float64, the factorized form
            exact = fac or value.dtype != torch.bfloat16 or attn.dtype != torch.bfloat16
            errs = []
            for gname, o, r in zip(("out", "dvalue", "dloc", "dattn"),
                                   (out.detach(), *(t.grad for t in leaves)),
                                   (plain_fwd(value, LEVELS, loc, attn),
                                    *plain_bwd(value, LEVELS, loc, attn, grad))):
                err = float((o.double() - r.double()).abs().max())
                rel = err / max(float(r.double().abs().max()), 1e-30)
                errs.append(f"{gname} {err:.2e}")
                tol = 0.0 if exact and gname != "dvalue" else TOL[value.dtype]
                if o.dtype != r.dtype or o.shape != r.shape or not rel <= tol:
                    raise AssertionError(f"[unprepared] {form} {name} ({dtype}): {gname} "
                                         f"max_abs_err {err:.3e}, rel {rel:.3e} (tol {tol})")
            want = expected({f"{op}_fwd": 1, f"{op}_bwd": 1, f"{op}_fwd_{kind}": 1,
                             f"{op}_bwd_{kind}": 1})
            if counts != want:
                raise AssertionError(f"[unprepared] {form} {name}: launches {counts}")
            for k, c in counts.items():
                total[k] += c
            log(f"[unprepared] {form} {str(value.dtype)[6:]} value, {str(attn.dtype)[6:]} "
                f"attention, {name}: max_abs_err vs plain {', '.join(errs)} "
                f"({'exact' if exact else 'dvalue'} within tol); {kind} kernels ok")
    return total


def research_phase():
    """Phase 3d: the research entry points, the slice's own path. With every
    count at 0, the ablation bench's timing mode runs every variant in bf16
    and in float32, and the two probes run; each kernel's launches must be
    exactly the calls the entry points made. Then the bench's --check mode
    holds every variant's kernel against its plain version in float32 and
    bf16 (launches checked, not counted on the path). Returns the numbers
    and the path's launches."""
    def tagged(tag):
        return lambda line: log(f"[ablation] {tag} {line}")

    reset_counts()
    bench, made = {}, {}
    for tag, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        bench[tag], calls = bench_msda_ablation.bench(list(bench_msda_ablation.VARIANTS), dtype,
                                                      "cuda", log=tagged(tag))
        for name, n in bench_msda_ablation.card_launches(calls).items():
            made[name] = made.get(name, 0) + n
    lane = probe_dynamic_lane_slice.run("cuda", log=log)
    gathers = probe_gather.run("cuda", log=log)
    # the probes time both kinds of their kernels: their launches by kind
    probe_calls = sum((r["calls_by_kind"] for r in gathers), lane["calls_by_kind"])
    for op in ("probe_lane_slice", "probe_gather"):
        probe_calls[op] = sum(n for k, n in probe_calls.items() if k.startswith(op + "_"))
    for line in ptxas_lines(msda_cuda.ptxas_report()):
        if "probe_" in line:
            log(f"[probes] {line}")
    counts = read_counts()
    want = expected({**staged(made), **probe_calls})
    log(f"[ablation] launches of the research path: {json.dumps(counts)}")
    if counts != want:
        raise AssertionError(f"research path: launches {counts}, expected {want}")
    check_err = {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        before = read_counts()
        rows, calls = bench_msda_ablation.check(list(bench_msda_ablation.VARIANTS), dtype,
                                                "cuda", log=tagged(f"--check {tag}"))
        delta = {n: c - before[n] for n, c in read_counts().items()}
        made_check = staged(bench_msda_ablation.card_launches(calls))
        if delta != expected(made_check):
            raise AssertionError(f"--check {tag}: launches {delta}, made {dict(made_check)}")
        if tag == "fp32":
            for r in rows:
                kernel = bench_msda_ablation.ROUTES[bench_msda_ablation.VARIANTS[
                    r["variant"]][0]][0]
                check_err[kernel] = max(check_err.get(kernel, 0.0), r["max_abs_err"])
    # the onlyg kinds in turns and the xdot kernel alone (launches checked, not counted)
    kinds = {}
    for tag, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        before = read_counts()
        kinds[tag], calls = bench_msda_ablation.kinds_ab(dtype, "cuda",
                                                         log=tagged(f"--kinds {tag}"))
        delta = {n: c - before[n] for n, c in read_counts().items()}
        made_ab = {**calls, "msda_onlyg": sum(n for k, n in calls.items()
                                              if k.startswith("msda_onlyg_"))}
        if delta != expected(made_ab):
            raise AssertionError(f"--kinds {tag}: launches {delta}, made {dict(made_ab)}")
    return dict(ablation=bench, lane=lane, gathers=gathers, check_err=check_err, launches=counts,
                kinds=kinds)


def probe_rows(numbers, by_path):
    """The `kernels` JSON rows of the probes' kernels, one a kind, from
    phase 3d's numbers: the lane slice's at the MSDA call site's shape
    (each case, the launch floor beside, under `cases`), the gather's at
    its largest case (every case it takes under `cases`)."""
    src = "uvhand_tpu_torch/ops/csrc/"
    lane, gathers = numbers["lane"], numbers["gathers"]
    keys = ("ms", "launched_ms")

    def row(name, kernel, nums, err, **extra):
        return {"name": name, "route": "cuda", "source": src + kernel + ".cu",
                "launches": numbers["launches"][name], "launches_by_path": by_path(name),
                "max_abs_err": err, **{k: nums[k] for k in keys}, "dtype": "float32", **extra}

    rows = []
    site = lane["cases"][-1]
    for kind in msda_cuda.LANE_SLICE_KINDS:
        rows.append(row(
            f"probe_lane_slice_{kind}", "probe_lane_slice", site["kinds"][kind],
            lane["max_abs_err"], replaces="scripts/probe_dynamic_lane_slice.py:39",
            **{k: site[k] for k in ("plain_ms", "bound_ms", "bound_by", "library_ms", "floor_ms")},
            case=site["case"], cases={c["case"]: {
                **{k: c[k] for k in ("bound_ms", "floor_ms", "plain_ms", "library_ms")},
                **c["kinds"][kind]} for c in lane["cases"]}))
    biggest = max(gathers, key=lambda r: r["bound_ms"])
    for kind in msda_cuda.GATHER_KINDS:
        rows.append(row(
            f"probe_gather_{kind}", "probe_gather", biggest["kinds"][kind],
            max(r["max_abs_err"] for r in gathers),
            replaces="scripts/repro_dynamic_gather.py:31, scripts/probe_gather_scale.py:28",
            **{k: biggest[k] for k in ("plain_ms", "bound_ms", "bound_by", "library_ms")},
            case=biggest["case"], cases={r["case"]: {
                **{k: r[k] for k in ("bound_ms", "plain_ms", "library_ms")},
                **r["kinds"][kind]} for r in gathers if kind in r["kinds"]}))
    return rows


def research_rows(numbers, by_path):
    """The `kernels` JSON rows of the research kernels from phase 3d's
    numbers; `by_path(name)` gives a kernel's launches on every path."""
    ablation = numbers["ablation"]
    src = "uvhand_tpu_torch/ops/csrc/"
    bench_script = "scripts/bench_msda_ablation.py"

    def row(name, nums, fp32_err, **extra):
        return {"name": name, "route": "cuda", "launches": numbers["launches"][name],
                "launches_by_path": by_path(name), "max_abs_err": fp32_err,
                **{k: nums[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                "library_ms": nums.get("library_ms"), **extra}

    def fp32_err(kernel):
        # the --check shapes and the bench's shapes
        errs = [r["max_abs_err"] for r in ablation["fp32"].values() if r["kernel"] == kernel]
        return max(errs + [numbers["check_err"].get(kernel, 0.0)])

    def variants_ms(kernel):
        return {tag: {v: r["ms"] for v, r in ablation[tag].items() if r["kernel"] == kernel}
                for tag in ablation}

    kinds = numbers["kinds"]
    replaces = {"msda_onlyg": f"{bench_script}:1215 (variant onlyg)",
                "msda_xdot": f"{bench_script}:1182 (variants xdot, xdotred)"}

    def kind_row(name):
        """A kind of onlyg, or xdot: its --kinds numbers in bf16 (fp32 beside
        them), its launches on the research path (the general onlyg: none)."""
        op = "msda_xdot" if name == "msda_xdot" else "msda_onlyg"
        bf, fp = kinds["bf16"][name], kinds["fp32"][name]
        return {"name": name, "route": "cuda", "source": f"{src}{op}.cu",
                "replaces": replaces[op], "launches": numbers["launches"][name],
                "launches_by_path": by_path(name),
                "max_abs_err": max(fp["max_abs_err"], 0.0 if name == "msda_onlyg_general"
                                   else fp32_err(op)),
                **{k: bf[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")},
                "dtype": "bfloat16", "max_rel_err_bf16": bf["max_rel_err"],
                **{f"{k}_fp32": fp[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                "library_ms")},
                **({"whole_variant_ms": variants_ms(op), "sector_ms": bf["sector_ms"],
                    "sector_ms_fp32": fp["sector_ms"]} if op == "msda_xdot" else
                   {"library_device_ms": bf["library_device_ms"],
                    "library_device_ms_fp32": fp["library_device_ms"],
                    "unrounded_rel_bf16": bf["unrounded_rel"]})}

    bf16 = ablation["bf16"]
    return [
        row("msda_ablate_bwd", bf16["full"], fp32_err("msda_ablate_bwd"),
            source=src + "msda_bwd.cu (entry msda_ablate_bwd)",
            replaces=f"{bench_script}:1215 (variants full, matred, signfree, fused, eqgate, "
                     "eqred, nodpy, nodaw, nodv)",
            dtype="bfloat16", ms_by_variant=variants_ms("msda_ablate_bwd")),
        *(kind_row(name) for name in ("msda_onlyg_tiled", "msda_onlyg_general", "msda_xdot")),
        *probe_rows(numbers, by_path),
    ]


# ------------------------------------------------------------ 4. main path


def synthetic_batch(rng, bank: objects.ObjectBank, B: int) -> dict:
    """A batch of GT drawn the way `make_synthetic_root(obj_bank=...)` draws
    it: the bank's canonical object posed by a sampled articulation, rotation
    and translation ~0.6 m in front of a 1000 px camera, hands near it, and
    2D keypoints that are the exact projections of the 3D GT. The training
    keys are set as `ArcticDataset` sets them: slots (object, left, right)
    with the object's class (1..11, alphabetical) and the hands' 12 / 13,
    and 21 projected keypoints each (the object's from its top and bottom
    keypoints, every third dropped, as the dataset picks them)."""
    mk = lambda *shape: rng.normal(size=shape).astype(np.float32)
    oidx = rng.integers(0, bank.num_objects, size=B).astype(np.int32)
    radian = np.abs(mk(B)) * 0.5
    rot = mk(B, 3) * 0.3
    transl = mk(B, 3) * np.array([0.08, 0.08, 0.05], np.float32) + np.array([0, 0, 0.6], np.float32)
    Rg = axis_angle_to_matrix(torch.from_numpy(rot)).numpy()
    Ra = rotate_about_axis(torch.from_numpy(radian), torch.tensor([0.0, 0.0, -1.0])).numpy()
    kp_top = bank.kp_top.cpu().numpy()[oidx]
    kp_bottom = bank.kp_bottom.cpu().numpy()[oidx]
    pose = lambda R, pts: (np.einsum("bij,bnj->bni", R, pts) + transl[:, None]).astype(np.float32)
    kp3d_b = pose(Rg, kp_bottom)
    kp3d_t = pose(Rg @ Ra, kp_top)
    K = np.tile(np.array([[1000.0, 0, IMG_RES / 2], [0, 1000.0, IMG_RES / 2], [0, 0, 1]],
                         np.float32), (B, 1, 1))

    def kp2d_norm(p3d):
        pix = np.einsum("bij,bnj->bni", K, p3d)
        return (2.0 * (pix[..., :2] / pix[..., 2:]) / IMG_RES - 1.0).astype(np.float32)

    ones = np.ones(B, np.float32)
    j3d_r = mk(B, 21, 3) * 0.05 + transl[:, None]
    j3d_l = mk(B, 21, 3) * 0.05 + transl[:, None]
    j2d_r, j2d_l = kp2d_norm(j3d_r), kp2d_norm(j3d_l)
    small_obj_idx = [i for i in range(32) if i % 3 != 0][:21]
    obj_kp = np.concatenate([kp2d_norm(kp3d_t), kp2d_norm(kp3d_b)], 1)[:, small_obj_idx]
    alphabetical = sorted(bank.names)
    obj_label = np.array([alphabetical.index(bank.names[i]) + 1 for i in oidx], np.int32)
    return {
        "images": mk(B, IMG_RES, IMG_RES, 3),
        "intrinsics": K,
        "query_idx": oidx,
        "is_valid": ones, "left_valid": ones, "right_valid": ones,
        "mano.pose.r": np.concatenate([mk(B, 3) * 0.3, mk(B, 45) * 0.2], 1),
        "mano.pose.l": np.concatenate([mk(B, 3) * 0.3, mk(B, 45) * 0.2], 1),
        "mano.beta.r": mk(B, 10) * 0.5,
        "mano.beta.l": mk(B, 10) * 0.5,
        "mano.j3d.full.r": j3d_r,
        "mano.j3d.full.l": j3d_l,
        "object.kp3d.full.b": kp3d_b,
        "object.kp2d.norm.b": kp2d_norm(kp3d_b),
        "object.kp2d.norm.t": kp2d_norm(kp3d_t),
        "object.rot": rot,
        "object.radian": radian,
        "transl": transl,  # what the GT translation solve must recover
        "labels": np.stack([obj_label, np.full(B, 12, np.int32), np.full(B, 13, np.int32)], 1),
        "keypoints": np.stack([obj_kp, j2d_l, j2d_r], 1).reshape(B, 3, 42),
        "target_valid": np.ones((B, 3), bool),
        "joints_valid_r": np.ones((B, 21), np.float32),
        "joints_valid_l": np.ones((B, 21), np.float32),
        "mano.j2d.norm.r": j2d_r,
        "mano.j2d.norm.l": j2d_l,
    }


def build_model(**options):
    """arctic_sf at full width (the defaults) on the card, seeded weights."""
    return UVHandDETR(generator=torch.Generator().manual_seed(SEED), device="cuda", **options)


def build_world(device, compute_dtype=torch.float32):
    model = build_model(compute_dtype=compute_dtype)
    world = (mano.synthetic_mano(0, True, device=device),
             mano.synthetic_mano(1, False, device=device),
             objects.synthetic_object_bank(2, device=device))
    return model, world


def set_msda_impl(model, impl):
    for mod in model.modules():
        if isinstance(mod, MSDeformAttn):
            mod.impl = impl


def reset_counts():
    for wrapper in KERNELS.values():
        wrapper.launches = 0


def read_counts():
    return {name: wrapper.launches for name, wrapper in KERNELS.items()}


def expected(per_call, calls=1):
    """Launches of every kernel that `calls` batches or steps must make."""
    return {name: per_call.get(name, 0) * calls for name in KERNELS}


@contextlib.contextmanager
def fac_formulation():
    """UVHAND_MSDA_FAC=1 for the phase; the environment restored after it."""
    old = os.environ.get("UVHAND_MSDA_FAC")
    os.environ["UVHAND_MSDA_FAC"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["UVHAND_MSDA_FAC"]
        else:
            os.environ["UVHAND_MSDA_FAC"] = old


def staged(per_op):
    """Launches by kernel of calls by op (`per_op`, by op name) where every
    op of VARIANTS runs its first kind (the staged MSDA kernels, the tiled
    onlyg kernel), as at arctic_sf's and the research scripts' shapes."""
    return {**per_op, **{f"{op}_{next(iter(VARIANTS[op]))}": n for op, n in per_op.items()
                         if op in VARIANTS}}


SERVE = staged({"msda_fwd": MSDA_PER_FORWARD})
TRAIN = staged({"msda_fwd": MSDA_PER_FORWARD, "msda_bwd": MSDA_PER_FORWARD})
SERVE_FAC = staged({"msda_fac_fwd": MSDA_PER_FORWARD})
TRAIN_FAC = staged({"msda_fac_fwd": MSDA_PER_FORWARD, "msda_fac_bwd": MSDA_PER_FORWARD})


def main_path_phase(model, world, batches, card, tag="fp32", per_batch=SERVE, frames=BATCH):
    step = engine.make_eval_step(model, *world, img_res=IMG_RES)
    reset_counts()
    rows, times = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows.append({k: v.cpu().numpy() for k, v in r.items()})
    counts = read_counts()
    for i, t in enumerate(times):
        log(f"[serve] {tag} batch {i}: {t * 1e3:.3f} ms, {frames / t:.1f} frames/s "
            f"(B={frames}, {tag}, {card})")
    want = expected(per_batch, len(batches))
    if counts != want:
        raise AssertionError(f"{tag} serving: MSDA kernel launches {counts}, expected {want}")
    log(f"[serve] {tag} MSDA kernel launches over {len(batches)} batches: {json.dumps(counts)}")
    for i, (r, batch) in enumerate(zip(rows, batches)):
        valid = batch["is_valid"] > 0
        for k, v in r.items():
            if v.shape != (frames,):
                raise AssertionError(f"metric {k} has shape {v.shape}")
            # CDev is NaN by definition for a frame whose GT has no contact
            finite = np.isfinite(v[valid]) | (np.isnan(v[valid]) if k == "cdev/ho" else False)
            if not finite.all():
                raise AssertionError(f"batch {i}: metric {k} not finite on valid frames: {v}")
    means = {k: float(np.nanmean(np.concatenate([r[k] for r in rows]))) for k in rows[0]}
    log(f"[serve] {tag} metrics (random weights): " + json.dumps(means))
    return rows, times, counts


def gt_phase(world, batch):
    """The GT solves recover the translation the synthetic object was drawn at."""
    from uvhand_tpu_torch.data.process import process_targets

    with torch.inference_mode():
        t = process_targets(engine.to_device(batch, "cuda"), *world, IMG_RES)
    err = float(np.abs(t["object.cam_t"].cpu().numpy() - batch["transl"]).max())
    log(f"[gt] object translation recovered to {err:.2e} m (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError("GT translation solve did not recover the drawn translation")


def e2e_phase(model, world, batch, kernel_rows, tag="fp32"):
    """The same batch with the plain MSDA versions: the same outputs and
    metric rows. Returns the kernel run's logits and keypoints."""
    with torch.inference_mode():
        images = torch.as_tensor(batch["images"], device="cuda")
        out_k = model(images)
        set_msda_impl(model, "torch")
        try:
            out_p = model(images)
            plain_rows = engine.make_eval_step(model, *world, img_res=IMG_RES)(batch)
        finally:
            set_msda_impl(model, "auto")
    worst = 0.0
    for k in KEYS:
        if out_p["stacked"][k] is None:  # the single-stage model has no keypoints
            continue
        d = float((out_k["stacked"][k] - out_p["stacked"][k]).abs().max())
        worst = max(worst, d)
        log(f"[e2e] {tag} {k}: kernel vs plain max_abs_diff={d:.3e} (tol 1e-4)")
    for k, v in plain_rows.items():
        a, b = kernel_rows[k], v.cpu().numpy()
        same_nan = np.array_equal(np.isnan(a), np.isnan(b))
        d = float(np.nanmax(np.abs(a - b))) if np.isfinite(a).any() else 0.0
        log(f"[e2e] {tag} metric {k}: kernel vs plain max_abs_diff={d:.3e} mm (tol 1e-2)")
        if not same_nan or d > 1e-2:
            raise AssertionError(f"metric {k}: kernel and plain runs disagree")
    if worst > 1e-4:
        raise AssertionError("kernel and plain MSDA runs disagree end to end")
    return out_k


def fac_fp32_phase(ref_out, images):
    """One float32 batch through the factorized kernels, held against
    phase 5's gather-kernel run of the same model and batch.

    The interm outputs (every token's encoder-head output; no discrete
    choice comes before them) agree within 1e-4. The decoder's outputs
    follow discrete choices -- the two-stage top-k of 300 among 1045
    scores and the class-gated refinement -- that a 1e-7 difference between
    the formulations flips at random weights (the top-k order, above all),
    so they are compared with those choices pinned, on the same weights and
    batch: the encoder class head reads nothing (every score ties and both
    runs take the lowest token indices) and every decoder class head
    prefers a hand class by 8. Then logits and keypoints agree within 1e-4.
    Returns the launches of the unpinned factorized batch."""
    model, _ = build_world("cuda")
    with torch.inference_mode():
        with fac_formulation():
            reset_counts()
            out = model(images)
            counts = read_counts()
        if counts != expected(SERVE_FAC):
            raise AssertionError(f"fp32 FAC batch: launches {counts}")
        diff = (out["stacked"]["pred_logits"] - ref_out["stacked"]["pred_logits"]).abs()
        moved = int((diff.amax(-1) > 1e-4).sum())
        log(f"[fac-e2e] fp32, phase 5's model and batch: {moved} of {diff[..., 0].numel()} "
            f"decoder query logits differ from the gather run's by more than 1e-4 (discrete "
            f"choices moved); then the interm outputs and the pinned model:")
    runs = [(f"interm {k}", out["interm_outputs"][k], ref_out["interm_outputs"][k])
            for k in KEYS]
    nd = model.num_decoder_layers
    with torch.no_grad():
        model.cls_embed[nd].weight.zero_()
        for head in model.cls_embed[:nd]:
            head.bias[12] = 8.0
    pinned = {}
    with torch.inference_mode():
        for fac in (False, True):
            with fac_formulation() if fac else contextlib.nullcontext():
                pinned[fac] = model(images)["stacked"]
        runs += [(f"pinned {k}", pinned[True][k], pinned[False][k]) for k in KEYS]
    for name, a, b in runs:
        d = float((a - b).abs().max())
        log(f"[fac-e2e] fp32 {name}: factorized vs gather kernels max_abs_diff={d:.3e} "
            f"(tol 1e-4)")
        if not d <= 1e-4:
            raise AssertionError(f"fp32 {name}: the two formulations disagree end to end")
    return counts


def profile_phase(model, world, batch):
    """Where one batch's time goes: host-clock stage times (each ending in a
    synchronize) and the profiler's device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from uvhand_tpu_torch.data.process import process_targets
    from uvhand_tpu_torch.evaluation.decode import decode_predictions
    from uvhand_tpu_torch.evaluation.metrics import measure_error
    from uvhand_tpu_torch.losses.criterion import select_queries

    b = engine.to_device(batch, "cuda")
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    reps = 3
    with torch.inference_mode():
        for _ in range(reps):
            targets = timed("process_targets", lambda: process_targets(b, *world, IMG_RES))
            timed("backbone+input_proj+posenc", lambda: model.level_features(b["images"]))
            out = timed("model forward (all)", lambda: model(b["images"]))
            last = {k: v[-1] for k, v in out["stacked"].items()}
            pred = timed("select+decode", lambda: decode_predictions(
                select_queries(last), targets, *world, IMG_RES))
            timed("metrics", lambda: measure_error(pred, targets, engine.BATCH_METRICS))
    for name, ms in stages.items():
        log(f"[profile] stage {name}: {ms / reps:.3f} ms")

    step = engine.make_eval_step(model, *world, img_res=IMG_RES)
    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    log(f"[profile] one step: wall {wall:.3f} ms, device busy {device_ms:.3f} ms "
        f"({100 * device_ms / wall:.1f}%), {n_kernels} device kernels and copies; MSDA device "
        f"ms (calls): {msda_device_ms(kernels)}")
    log(events.table(sort_by="self_cuda_time_total", row_limit=25, max_name_column_width=60))


# ------------------------------------------------------------ 7-9. training


def train_ab_phase(model, world, batch, grad_tol=1e-3, tag="fp32", require=()):
    """One loss and backward in train mode (dropout and feature mask on)
    from the same weights and generator seed, with the kernels and with the
    plain MSDA versions. Loss terms within 1e-4 relative; each gradient
    within `grad_tol` of its tensor's max (the backward kernel's float32
    dvalue sums are atomics in no fixed order, and cuDNN's weight gradients
    are not bit-repeatable either; in bf16 a last-bit change of a dvalue
    sum moves its bf16 rounding a whole bf16 step). A model with CDN
    queries takes one draw of them (`dn_meta`), injected into both runs,
    and its `*_dn` loss terms must be there, as must the terms `require`
    names."""
    loss_fn = engine.make_loss_fn(model, *world, img_res=IMG_RES)
    tb = engine.to_device(batch, "cuda", engine.TRAIN_KEYS)
    dn_meta = None
    if getattr(model, "use_dn", False):
        with torch.no_grad():
            t = engine.dn_targets(tb)
            dn_meta = prepare_cdn(torch.Generator(device="cuda").manual_seed(SEED + 7),
                                  t["labels"], t["keypoints"], t["target_valid"],
                                  model.num_classes, model.cdn)
    params = dict(model.named_parameters())
    runs = {}
    model.train()
    try:
        for impl in ("auto", "torch"):
            set_msda_impl(model, impl)
            model.zero_grad(set_to_none=True)
            total, ld = loss_fn(tb, torch.Generator(device="cuda").manual_seed(SEED), dn_meta)
            total.backward()
            runs[impl] = ({k: float(v.detach()) for k, v in ld.items()},
                          {n: p.grad.clone() for n, p in params.items() if p.grad is not None})
    finally:
        set_msda_impl(model, "auto")
        model.zero_grad(set_to_none=True)
    (ld_k, g_k), (ld_p, g_p) = runs["auto"], runs["torch"]
    loss_worst = max(abs(ld_k[k] - ld_p[k]) / max(abs(ld_p[k]), 1e-2) for k in ld_p)
    bad = [k for k in ld_p if not abs(ld_k[k] - ld_p[k]) <= 1e-4 * abs(ld_p[k]) + 1e-6]
    log(f"[train-ab] {tag} {len(ld_p)} loss terms, worst relative diff {loss_worst:.3e} "
        f"(tol 1e-4)")
    if set(g_k) != set(g_p) or bad:
        raise AssertionError(f"kernel and plain train passes disagree on losses {bad}")
    if dn_meta is not None and not {"loss_ce_dn", "loss_hand_keypoint_dn",
                                    "loss_obj_keypoint_dn"} <= set(ld_p):
        raise AssertionError(f"{tag}: no dn loss terms in {sorted(ld_p)}")
    if not set(require) <= set(ld_p):
        raise AssertionError(f"{tag}: loss terms {sorted(set(require) - set(ld_p))} missing")
    worst, worst_name = 0.0, ""
    for n, gp in g_p.items():
        rel = float((g_k[n] - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, n
    log(f"[train-ab] {tag} {len(g_p)} gradients, worst {worst:.3e} of its tensor's max "
        f"({worst_name}; tol {grad_tol:.0e})")
    if worst > grad_tol:
        raise AssertionError("kernel and plain train passes disagree on gradients")


def train_phase(model, world, batches, card, tag="fp32", per_step=TRAIN, sgd=False,
                frames=BATCH):
    """The training path: make_fused_train_step with the CLI's defaults
    (AdamW, or SGD with `sgd`; bfloat16 parameters take the stochastic-
    rounding optimizer, and must stay bfloat16 and finite)."""
    # lr 2e-4, backbone 2e-5, linear proj x0.1, wd 1e-4
    opt = create_optimizer(model, sgd=sgd, sr_seed=SEED)
    step = engine.make_fused_train_step(
        model, *world, opt, img_res=IMG_RES, clip_max_norm=0.1,
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    labels = label_params(model)
    params = dict(model.named_parameters())
    times = []
    reset_counts()
    for i, batch in enumerate(batches):
        old = {n: p.detach().clone() for n, p in params.items()}
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ld = step(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        after = read_counts()
        vals = {k: float(v) for k, v in ld.items()}
        bad = sorted(k for k, v in vals.items() if not np.isfinite(v))
        moved = {g: any(not torch.equal(p, old[n]) for n, p in params.items() if labels[n] == g)
                 for g in set(labels.values())}
        delta = {n: after[n] - before[n] for n in KERNELS}
        log(f"[train] {tag} step {i}: {dt * 1e3:.3f} ms, {frames / dt:.1f} frames/s (B={frames}, "
            f"{tag}, {card}); total {vals['total']:.6g}, grad_norm {vals['grad_norm']:.6g}, "
            f"launches {json.dumps({n: f'+{d}' for n, d in delta.items() if d})}, "
            f"groups moved {moved}")
        if bad or not vals["grad_norm"] > 0:
            raise AssertionError(f"step {i}: non-finite losses {bad} or grad_norm "
                                 f"{vals['grad_norm']}")
        if delta != expected(per_step):
            raise AssertionError(f"{tag} step {i}: MSDA launches {delta}, "
                                 f"expected {expected(per_step)}")
        if not all(moved.values()):
            raise AssertionError(f"step {i}: a parameter group did not move: {moved}")
        if "label_enc.weight" in params and torch.equal(params["label_enc.weight"],
                                                        old["label_enc.weight"]):
            raise AssertionError(f"{tag} step {i}: the dn label embedding did not move")
        bad = [n for n, p in params.items()
               if p.dtype != old[n].dtype or not bool(torch.isfinite(p).all())]
        if bad:
            raise AssertionError(f"{tag} step {i}: parameters changed type or are not "
                                 f"finite: {bad[:3]}")
    counts = read_counts()
    log(f"[train] {tag} MSDA kernel launches over {len(batches)} steps: {json.dumps(counts)}")
    log(f"[train] {tag} last step's losses: " + json.dumps(vals))
    return times, counts


def train_profile_phase(model, world, batch):
    """Where one train step's time goes, from the profiler over one step of
    make_fused_train_step itself: each stage's host time and the device time
    of the kernels it launched (its `engine.TRAIN_STAGES` range), and the
    device's busy share of the wall clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    opt = create_optimizer(model)
    step = engine.make_fused_train_step(model, *world, opt, img_res=IMG_RES,
                                        generator=torch.Generator(device="cuda").manual_seed(SEED))
    step(batch)
    torch.cuda.synchronize()
    reps = 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    events = prof.key_averages()
    ranges = {e.key: e for e in events
              if e.key in engine.TRAIN_STAGES and e.device_type == DeviceType.CPU}
    attributed = 0.0
    for name in engine.TRAIN_STAGES:
        e = ranges[name]
        attributed += e.device_time_total / 1e3 / reps
        log(f"[train-profile] stage {name}: host {e.cpu_time_total / 1e3 / reps:.3f} ms, "
            f"device {e.device_time_total / 1e3 / reps:.3f} ms")
    # device-side annotations (these ranges, torch's Optimizer.step) are spans, not work
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    n_kernels = sum(e.count for e in kernels) // reps
    # autograd runs a CUDA backward on its own device thread, outside the
    # caller's ranges: the backward's kernels (and the input copies) land here
    log(f"[train-profile] device time outside the stages' threads (autograd's device "
        f"thread, input copies): {device_ms - attributed:.3f} ms")
    log(f"[train-profile] one step: wall {wall:.3f} ms, device busy {device_ms:.3f} ms "
        f"({100 * device_ms / wall:.1f}%), {n_kernels} device kernels and copies; MSDA device "
        f"ms (calls): {msda_device_ms(kernels)}")
    log(events.table(sort_by="self_cuda_time_total", row_limit=25, max_name_column_width=60))


def profile_line(label, fn):
    """One profiled call of `fn` (after a warm-up call): wall clock, the
    device's busy share, device kernels and copies, and each MSDA kernel's
    device ms and calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] {label}: wall {wall:.3f} ms, device busy {device_ms:.3f} ms "
        f"({100 * device_ms / wall:.1f}%), {sum(e.count for e in kernels)} device kernels and "
        f"copies; MSDA device ms (calls): {msda_device_ms(kernels)}")


def msda_device_ms(kernels):
    """Each MSDA kernel's device ms and calls among the profiler's device
    events `kernels`, for a log line."""
    msda = {}
    for e in kernels:
        name = next((n for n in KERNELS if f"{n}_kernel" in e.key), None)
        if name:
            ms, calls = msda.get(name, (0.0, 0))
            msda[name] = (ms + e.self_device_time_total / 1e3, calls + e.count)
    return ", ".join(f"{n} {ms:.3f} ({c})" for n, (ms, c) in sorted(msda.items()))


# ------------------------------------------------------------ 14. model options

#: the model and training options of arctic_sf's CLI, each at full width:
#: (tag, UVHandDETR options, train-step options, launches per train step);
#: no-aux, remat and sgd serve with the default model's forward (phase 6
#: profiles it)
#: phase 14 runs each option at full width with the decoder cut to 2 of its 6
#: layers: a step's host work grows with the decoder layers the criterion
#: covers, and the whole script must stay well inside its time limit
OPTION_DEC_LAYERS = 2
OPTION_PER_FORWARD = 6 + OPTION_DEC_LAYERS
OPTION_SERVE = staged({"msda_fwd": OPTION_PER_FORWARD})
OPTION_TRAIN = staged({"msda_fwd": OPTION_PER_FORWARD, "msda_bwd": OPTION_PER_FORWARD})
OPTIONS = (
    ("single-stage", dict(two_stage=False, with_box_refine=False), {}, OPTION_TRAIN),
    ("learned posenc", dict(position_embedding="learned"), {}, OPTION_TRAIN),
    ("no-aux", dict(aux_loss=False), {}, OPTION_TRAIN),
    ("enc_lite 3", dict(enc_lite=True, enc_lite_hi_every=3), {}, OPTION_TRAIN),
    ("enc_lite 6", dict(enc_lite=True, enc_lite_hi_every=6), {}, OPTION_TRAIN),
    # every layer's forward again in the backward
    ("remat", dict(remat=True), {},
     staged({"msda_fwd": 2 * OPTION_PER_FORWARD, "msda_bwd": OPTION_PER_FORWARD})),
    ("bf16 params", dict(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16), {},
     OPTION_TRAIN),
    ("sgd", {}, dict(sgd=True), OPTION_TRAIN),
)
OPTION_BATCHES, OPTION_STEPS = 2, 2


def options_phase(world, batches, train_batches, card):
    """Phase 14: each model and training option of arctic_sf at full width
    (B=16, 224x224, d=256, 300 queries), its depth cut to 6 encoder and 2
    decoder layers: 2 serving batches (8 staged forward launches each,
    enc_lite's low-resolution-only layers included) held end to end against
    the plain MSDA run of the same model and batch, 2 train steps with exact
    launches (remat: 16 forward + 8 backward a step), and a profiled train
    step and, where the forward differs from the default's, serving batch
    (device busy share). Returns {tag: (serving launches, training
    launches)}."""
    t_phase = time.perf_counter()
    counts = {}
    for tag, options, train_options, per_step in OPTIONS:
        model = build_model(num_decoder_layers=OPTION_DEC_LAYERS, **options)
        rows, _, serve = main_path_phase(model, world, batches[:OPTION_BATCHES], card, tag,
                                         OPTION_SERVE)
        e2e_phase(model, world, batches[0], rows[0], tag)
        if tag not in ("no-aux", "remat", "sgd"):
            step = engine.make_eval_step(model, *world, img_res=IMG_RES)
            profile_line(f"{tag} serving batch", lambda: step(batches[1]))
        _, train = train_phase(model, world, train_batches[:OPTION_STEPS], card, tag, per_step,
                               **train_options)
        opt = create_optimizer(model, sgd=train_options.get("sgd", False), sr_seed=SEED)
        train_step = engine.make_fused_train_step(
            model, *world, opt, img_res=IMG_RES,
            generator=torch.Generator(device="cuda").manual_seed(SEED))
        profile_line(f"{tag} train step", lambda: train_step(train_batches[1]))
        counts[tag] = (serve, train)
        del model, opt, train_step
    log(f"[options] phase 14 took {time.perf_counter() - t_phase:.2f} s of wall clock")
    return counts


def remat_memory_phase(world, rng, card):
    """Peak device memory (`torch.cuda.max_memory_allocated`) of one full-width
    fp32 train step with and without remat, at B=16 and B=32, and its time.
    Every step must fit the card, and remat must lower the peak."""
    for B in (BATCH, 2 * BATCH):
        batch = synthetic_batch(rng, world[2], B)
        peaks = {}
        for remat in (False, True):
            model = build_model(remat=remat)
            step = engine.make_fused_train_step(
                model, *world, create_optimizer(model), img_res=IMG_RES,
                generator=torch.Generator(device="cuda").manual_seed(SEED))
            step(batch)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            peak = peaks[remat] = torch.cuda.max_memory_allocated()
            log(f"[remat-memory] B={B} remat={remat}: peak {peak / 2**30:.3f} GiB "
                f"allocated ({(peak - base) / 2**30:.3f} GiB above the step's resident "
                f"{base / 2**30:.3f} GiB), step {(time.perf_counter() - t0) * 1e3:.1f} ms "
                f"({card})")
            del model, step
            torch.cuda.empty_cache()
        if not peaks[True] < peaks[False]:
            raise AssertionError(f"[remat-memory] B={B}: remat did not lower the peak {peaks}")


# ------------------------------------------------------------ 13. the CLI

#: the [cli] phase's synthetic ARCTIC root: 2 sequences x 17 frames x 2
#: views = 68 frames, 4 train batches of 16 (drop_last) and 5 val batches
CLI_SEQS, CLI_FRAMES, CLI_VIEWS = 2, 17, 2
CLI_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cli_smoke")


def cli_root(path):
    """A synthetic ARCTIC root for the CLI (`make_synthetic_root` with the
    object bank the CLI builds when no meshes are present, so the object GT
    is consistent with it). In sequence 0 frames 1..15 are made one static
    frame (every view), and in view 0 the right hand is moved so that a
    hand vertex touches an object vertex over them: a contact window of 15
    frames that touches neither end of the sequence, so MDev has a window
    to measure. Returns the root."""
    from uvhand_tpu_torch.data.process import process_targets

    root = os.path.join(path, "arctic")
    bank = objects.synthetic_object_bank(2, device="cpu")
    arctic.make_synthetic_root(root, num_seqs=CLI_SEQS, frames=CLI_FRAMES, views=CLI_VIEWS,
                               seed=SEED, obj_bank=bank)
    files = [os.path.join(root, f"splits/p1_{split}.npy") for split in ("train", "val")]
    data = np.load(files[0], allow_pickle=True).item()
    key = sorted(data["data_dict"])[0]
    seq = data["data_dict"][key]
    window = slice(2, CLI_FRAMES - 1)
    for group in ("cam_coord", "2d", "params"):
        for arr in seq[group].values():
            arr[window] = arr[1]
    seq["bbox"][window] = seq["bbox"][1]

    def save():
        for f in files:
            np.save(f, data, allow_pickle=True)

    def contact(frame_name):
        save()
        ds = arctic.ArcticDataset(root, "p1", "val", kp3d_cano=bank.kp_bottom.numpy())
        batch = arctic.collate([ds[ds.imgnames.index(frame_name)]])
        world = (mano.synthetic_mano(0, True, device="cpu"),
                 mano.synthetic_mano(1, False, device="cpu"), bank)
        with torch.inference_mode():
            t = process_targets(engine.to_device(batch, "cpu"), *world, IMG_RES)
        return t["mano.v3d.cam.r"][0], t["object.v.cam"][0], t["dist.ro"][0]

    name = next(n for n in data["imgnames"] if f"/{key.split('/')[1]}/0/00001." in n)
    v_r, v_o, _ = contact(name)
    seq["cam_coord"]["joints.right"][1:CLI_FRAMES - 1, 0] += (v_o[0] - v_r[0]).numpy()
    _, _, dist = contact(name)
    if not float(dist.min()) < 1e-3:
        raise AssertionError(f"[cli] the contact window was not made: min dist.ro {dist.min()}")
    return root


def cli_argv(data_dir, out, *extra, two_stage=True):
    """The CLI's flags for arctic_sf at full width (the defaults: R50, d=256,
    8 heads, 6+6 layers, FFN 1024, 300 queries, 4 levels), two-stage with
    box refinement (or the CLI's default single-stage model), batches of 16,
    `--debug` steps."""
    model = ["--two_stage", "--with_box_refine"] if two_stage else []
    return ["--dataset_file", "arctic", "--coco_path", data_dir, "--output_dir", out,
            *model, "--batch_size", str(BATCH),
            "--val_batch_size", str(BATCH), "--epochs", "1", "--debug", "--num_workers", "8",
            "--seed", str(SEED), *extra]


def cli_phase(card):
    """Phase 13: arctic_sf through the port's CLI (`cli.main.main`) on a
    synthetic ARCTIC root on disk. Three runs, each with every count set to
    0 just before it and read just after:
      1. an fp32 epoch of 4 `--debug` steps and its end-of-epoch eval (4
         batches), writing out/0/checkpoint.pth;
      2. `--eval --resume out/0` with the default metrics: 4 batches and
         the sequence pass (ACC, MDev) over the 4 (sequence, view) groups;
      3. a `--bf16` epoch of 2 steps under UVHAND_MSDA_FAC=1, its eval 2
         batches;
      4-5. the CLI's default single-stage model with `--enc_lite --remat`:
         an epoch of 2 steps and its eval, then `--eval --resume`;
      6-7. `--two_stage --with_box_refine --bf16_params --sgd`: the same.
    Checks: 12 staged forward launches a batch and 12 + 12 a step (the
    factorized kernels in run 3; 24 + 12 under remat), no general or
    research launch; each resumed eval's batch scores equal its in-process
    eval's; every score finite; the loader's prefetched CUDA batches equal its host batches bit
    for bit. Prints the steady step ms, the wait for the loader a step,
    the loader's frames/s with no model, the eval batch ms and each run's
    wall clock. Returns the launches of each run."""
    t_phase = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    data_dir = os.path.join(CLI_DIR, "data")
    t0 = time.perf_counter()
    root = cli_root(data_dir)
    log(f"[cli] synthetic root of {CLI_SEQS * CLI_FRAMES * CLI_VIEWS} frames written in "
        f"{time.perf_counter() - t0:.2f} s")

    # the data path alone: the loader's rate, and its prefetch to the card
    ds = arctic.ArcticDataset(root, "p1", "train", seed=SEED,
                              kp3d_cano=objects.synthetic_object_bank(2, device="cpu").kp_bottom.numpy())
    loader = DataLoader(ds, BATCH, seed=SEED, num_workers=8)
    try:
        t0 = time.perf_counter()
        host = list(loader)
        rate = len(host) * BATCH / (time.perf_counter() - t0)
        n = 0
        for got, want in zip(device_prefetch(loader, "cuda"), host):
            for k, v in want.items():
                if not (got[k].is_cuda and torch.equal(got[k].cpu(), torch.from_numpy(v))):
                    raise AssertionError(f"[cli] prefetched batch {n}: {k} differs from the "
                                         f"host batch")
            n += 1
        torch.cuda.synchronize()
    finally:
        loader.close()
    if n != len(host) or n < 4:
        raise AssertionError(f"[cli] {n} prefetched batches of {len(host)}")
    log(f"[cli] loader alone (8 thread workers, augmentation on, decode + crop + collate): "
        f"{rate:.1f} frames/s over {len(host)} batches of {BATCH} (one epoch, cold); "
        f"{n} batches prefetched to the card equal the host batches bit for bit ({card})")

    out = os.path.join(CLI_DIR, "out")
    parse = cli.get_args_parser().parse_args
    runs = {}

    def run(tag, argv, want):
        reset_counts()
        t0 = time.perf_counter()
        res = cli.main(parse(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"[cli] {tag}: launches {counts}, expected {want}")
        timing = res["timing"]
        steps, waits = timing.get("step_ms", []), timing.get("wait_ms", [])
        parts = [f"wall clock {wall:.2f} s (model build, data and compile included)"]
        if steps:
            parts.append(f"steps {', '.join(f'{x:.1f}' for x in steps)} ms (steady "
                         f"{np.median(steps[1:]) if len(steps) > 1 else steps[0]:.1f} ms), "
                         f"waiting on the loader {', '.join(f'{x:.1f}' for x in waits)} ms "
                         f"a step")
        parts.append(f"eval batches {', '.join(f'{x:.1f}' for x in timing['batch_ms'])} ms")
        log(f"[cli] {tag}: {'; '.join(parts)}; launches "
            f"{json.dumps({k: v for k, v in counts.items() if v})} ({card})")
        runs[tag] = counts
        return res

    per_step = {"msda_fwd": MSDA_PER_FORWARD, "msda_bwd": MSDA_PER_FORWARD}
    train = run("fp32 train epoch", cli_argv(data_dir, out, "--num_debug", "4"),
                expected(staged({k: 2 * v if k == "msda_fwd" else v
                                 for k, v in per_step.items()}), 4))
    seq_batches = CLI_SEQS * CLI_VIEWS * -(-CLI_FRAMES // BATCH)
    evald = run("fp32 eval --resume out/0", cli_argv(
        data_dir, os.path.join(CLI_DIR, "eval"), "--num_debug", "4", "--eval", "--resume",
        os.path.join(out, "0")), expected(SERVE, 4 + seq_batches))
    with fac_formulation():
        bf16 = run("bf16 FAC train epoch", cli_argv(
            data_dir, os.path.join(CLI_DIR, "bf16"), "--num_debug", "2", "--bf16"),
            expected(staged({"msda_fac_fwd": 2 * MSDA_PER_FORWARD,
                             "msda_fac_bwd": MSDA_PER_FORWARD}), 2))

    remat = {"msda_fwd": 2 * MSDA_PER_FORWARD + MSDA_PER_FORWARD,
             "msda_bwd": MSDA_PER_FORWARD}  # a step's and an eval batch's launches
    option_runs = {}
    for tag, flags, two_stage, per_step in (
            ("single-stage enc_lite remat", ["--enc_lite", "--remat"], False, remat),
            ("bf16-params sgd", ["--bf16_params", "--sgd"], True,
             {"msda_fwd": 2 * MSDA_PER_FORWARD, "msda_bwd": MSDA_PER_FORWARD})):
        out_dir = os.path.join(CLI_DIR, tag.replace(" ", "_"))
        epoch = run(f"{tag} train epoch", cli_argv(
            data_dir, out_dir, "--num_debug", "2", *flags, two_stage=two_stage),
            expected(staged(per_step), 2))
        resumed_run = run(f"{tag} eval --resume", cli_argv(
            data_dir, out_dir + "_eval", "--num_debug", "2", "--eval", "--resume",
            os.path.join(out_dir, "0"), *flags, two_stage=two_stage),
            expected(SERVE, 2 + seq_batches))
        option_runs[tag] = (epoch, resumed_run)

    def same_scores(tag, in_process, resumed):
        for k, v in in_process.items():
            if not (v == resumed[k] or (np.isnan(v) and np.isnan(resumed[k]))):
                raise AssertionError(f"[cli] {tag} {k}: resumed eval {resumed[k]} != "
                                     f"in-process {v}")

    in_process = train["epochs"][0]["scores"]
    resumed = evald["scores"][0]
    same_scores("fp32", in_process, resumed)
    for tag, (epoch, resumed_run) in option_runs.items():
        same_scores(tag, epoch["epochs"][0]["scores"], resumed_run["scores"][0])
        log(f"[cli] {tag}: losses {json.dumps(epoch['epochs'][0]['stats'])}, resumed scores "
            f"(equal to the in-process eval's) {json.dumps(resumed_run['scores'][0])}")
    log(f"[cli] the resumed eval's batch scores equal the end-of-epoch eval's: "
        f"{json.dumps(in_process)}")
    log(f"[cli] resumed eval, default metrics (random weights): {json.dumps(resumed)}")
    log(f"[cli] bf16 FAC epoch: losses {json.dumps(bf16['epochs'][0]['stats'])}, scores "
        f"{json.dumps(bf16['epochs'][0]['scores'])}")
    scores = {**{f"train {k}": v for k, v in train["epochs"][0]["stats"].items()},
              **{f"eval {k}": v for k, v in resumed.items()},
              **{f"bf16 {k}": v for k, v in bf16["epochs"][0]["stats"].items()},
              **{f"bf16 eval {k}": v for k, v in bf16["epochs"][0]["scores"].items()},
              **{f"{tag} {k}": v for tag, (epoch, resumed_run) in option_runs.items()
                 for k, v in {**epoch["epochs"][0]["stats"],
                              **resumed_run["scores"][0]}.items()}}
    bad = sorted(k for k, v in scores.items() if not np.isfinite(v))
    if bad or not {"acc/h", "acc/o", "mdev/h"} <= set(resumed):
        raise AssertionError(f"[cli] scores not finite or missing: {bad}")
    log(f"[cli] phase 13 took {time.perf_counter() - t_phase:.2f} s of wall clock")
    return runs


#: phase 16: the CLI under torch.distributed.run at world size 1, an fp32
#: `--debug` epoch of LAUNCH_STEPS steps (and as many eval batches), then
#: `--eval --resume` with the per-batch metrics
LAUNCH_STEPS = 2
LAUNCH_TIMEOUT_S = 300
BATCH_METRIC_FLAGS = ("--eval_metrics", "aae", "mpjpe.ra", "mrrpe", "success_rate", "cdev")
#: phase 17: the bench's steps or batches a mode, after its warm-up one
BENCH_SCAN = 4
BENCH_TIMEOUT_S = 420
REPO = os.path.dirname(os.path.abspath(__file__))


def launched(tag, argv, timeout_s, **env):
    """Run `argv` from the root of the checkout as a process group of its
    own, with UVHAND_LAUNCH_COUNTS_DIR set, so that every process of it
    that imports the kernels writes its launches when it exits; on a
    failure or past `timeout_s` the whole group is killed. -> (its standard
    output, the launches summed over its processes)."""
    counts_dir = os.path.join(CLI_DIR, "launches", tag.replace(" ", "_"))
    shutil.rmtree(counts_dir, ignore_errors=True)
    proc = subprocess.Popen(argv, cwd=REPO, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, start_new_session=True,
                            env={**os.environ, "PYTHONPATH": REPO,
                                 msda_cuda.COUNTS_DIR_ENV: counts_dir, **env})
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise AssertionError(f"[{tag}] did not end within {timeout_s} s")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
    if proc.returncode:
        raise AssertionError(f"[{tag}] exited with {proc.returncode}:\n{out[-2000:]}\n"
                             f"{err[-4000:]}")
    counts = dict.fromkeys(KERNELS, 0)
    if not os.path.isdir(counts_dir) or not os.listdir(counts_dir):
        raise AssertionError(f"[{tag}] no process wrote its launches")
    for name in os.listdir(counts_dir):
        with open(os.path.join(counts_dir, name)) as f:
            for k, v in json.load(f).items():
                counts[k] += v
    return out, counts


def last_json_line(path):
    with open(path) as f:
        return json.loads(f.read().splitlines()[-1])


def launcher_phase(card):
    """Phase 16: the CLI as a multi-process user launches it, at world size 1
    (the card host has one H100; NCCL runs one rank a device):
    `python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    uvhand_tpu_torch.cli.main` on phase 13's synthetic root, an fp32
    `--debug` epoch of LAUNCH_STEPS steps and its eval, then `--eval
    --resume` of its checkpoint. Checks: the process group is NCCL's with
    one process; 12 staged forward launches a batch and 12 + 12 a step and
    no other kernel (each process's counts, written when it exits); the
    one writer's files, one checkpoint among them; the epoch's losses and
    losses within 1e-4 (relative) of the same flags run without the
    launcher (`cli.main.main` in this process: the backward kernel's dvalue
    atomics and cuDNN's weight gradients are not bit-repeatable, so the
    second step starts from other last bits, and the two models' scores
    then differ by the argmax choices those bits move, logged); the
    epoch's scores equal bit for bit to the launched `--resume` eval's and
    to this process's eval of the same checkpoint.
    Returns the launches of the two launched runs."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    data_dir = os.path.join(CLI_DIR, "data")
    out = {tag: os.path.join(CLI_DIR, f"launch_{tag}")
           for tag in ("train", "eval", "plain_train", "plain_eval")}
    for path in out.values():
        shutil.rmtree(path, ignore_errors=True)
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1", "-m", "uvhand_tpu_torch.cli.main"]
    steps = ["--num_debug", str(LAUNCH_STEPS)]
    runs, walls = {}, {}

    def run(tag, argv, want):
        t0 = time.perf_counter()
        stdout, counts = launched(f"torchrun {tag}", torchrun + argv, LAUNCH_TIMEOUT_S)
        walls[tag] = time.perf_counter() - t0
        if counts != want:
            raise AssertionError(f"[torchrun] {tag}: launches {counts}, expected {want}")
        topo = ("multihost: {'process_index': 0, 'process_count': 1, 'local_devices': 1, "
                "'global_devices': 1} backend=nccl")
        if topo not in stdout:
            raise AssertionError(f"[torchrun] {tag}: no NCCL process group of one process in "
                                 f"its output:\n{stdout[-2000:]}")
        runs[tag] = counts

    run("train", cli_argv(data_dir, out["train"], *steps),
        expected(staged({"msda_fwd": 2 * MSDA_PER_FORWARD, "msda_bwd": MSDA_PER_FORWARD}),
                 LAUNCH_STEPS))
    files = sorted(os.listdir(out["train"]))
    if files != ["0", "0.meta.json", "loss.txt", "results.txt", "running_cmd.json"] or \
            os.listdir(os.path.join(out["train"], "0")) != ["checkpoint.pth"]:
        raise AssertionError(f"[torchrun] the writer's files: {files}")
    run("eval --resume", cli_argv(data_dir, out["eval"], *steps, *BATCH_METRIC_FLAGS,
                                  "--eval", "--resume", os.path.join(out["train"], "0")),
        expected(SERVE, LAUNCH_STEPS))

    # the same flags without the launcher, and this process's eval of the
    # launched run's checkpoint
    parse = cli.get_args_parser().parse_args
    t0 = time.perf_counter()
    cli.main(parse(cli_argv(data_dir, out["plain_train"], *steps)))
    cli.main(parse(cli_argv(data_dir, out["plain_eval"], *steps, *BATCH_METRIC_FLAGS,
                            "--eval", "--resume", os.path.join(out["train"], "0"))))
    walls["without the launcher, both"] = time.perf_counter() - t0

    def read(tag, name):
        row = last_json_line(os.path.join(out[tag], name))
        row.pop("epoch")
        return row

    losses, plain_losses = read("train", "loss.txt"), read("plain_train", "loss.txt")
    rel = {k: abs(losses[k] - v) / max(abs(v), 1e-30) for k, v in plain_losses.items()}
    if not all(r <= 1e-4 for r in rel.values()):
        raise AssertionError(f"[torchrun] epoch losses {losses} against {plain_losses} "
                             f"without the launcher")
    scores = {tag: read(tag, "results.txt") for tag in ("train", "eval", "plain_eval")}
    if not json.dumps(scores["train"]) == json.dumps(scores["eval"]) == json.dumps(
            scores["plain_eval"]):
        raise AssertionError(f"[torchrun] the epoch's scores, the launched resumed eval's and "
                             f"this process's eval of the same checkpoint differ: {scores}")
    plain_scores = read("plain_train", "results.txt")
    moved = {k: abs(scores["train"][k] - v) / max(abs(v), 1e-30)
             for k, v in plain_scores.items()}
    log(f"[torchrun] world size 1 under NCCL: launches train "
        f"{json.dumps({k: v for k, v in runs['train'].items() if v})}, eval "
        f"{json.dumps({k: v for k, v in runs['eval --resume'].items() if v})}; one writer, "
        f"one checkpoint; epoch losses {json.dumps(losses)}, relative to the run without the "
        f"launcher {json.dumps(rel)} (limit 1e-4); the epoch's scores equal bit for bit to "
        f"the launched resumed eval's and to this process's eval of that checkpoint "
        f"{json.dumps(scores['train'])}; the run without the launcher's scores (another "
        f"model after 2 steps: atomics) relative {json.dumps(moved)}, not checked; wall "
        f"clock {json.dumps({k: round(v, 2) for k, v in walls.items()})} s ({card})")
    log(f"[torchrun] phase 16 took {time.perf_counter() - t_phase:.2f} s of wall clock")
    return runs


def bench_phase(card):
    """Phase 17: `python -m uvhand_tpu_torch.bench` with UVHAND_BENCH_SCAN =
    BENCH_SCAN: its first line is the bf16 train headline, finite and > 0;
    every mode's line a rate (the Swin-L train line too), none
    an error or a skip; launches 12 (+ 12 backward) a call of each mode, its
    warm-up included (the window-32 train step, under remat, 24 + 12), all
    staged.
    Logs its lines as the bench printed them, beside the card."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    stdout, counts = launched("bench", [sys.executable, "-m", "uvhand_tpu_torch.bench"],
                              BENCH_TIMEOUT_S, UVHAND_BENCH_SCAN=str(BENCH_SCAN))
    lines = stdout.splitlines()
    rows = [json.loads(line) for line in lines]
    head = rows[0]
    if not (head.get("metric") == "train_frames_per_sec_chip" and head.get("dtype") == "bfloat16"
            and np.isfinite(head.get("value", np.nan)) and head["value"] > 0):
        raise AssertionError(f"[bench] the first line is not the headline: {lines[0]}")
    timed = [r for r in rows if "value" in r]
    bad = [r for r in rows if not ("value" in r and np.isfinite(r["value"]) and r["value"] > 0)]
    if bad or len(timed) != 8:
        raise AssertionError(f"[bench] lines {bad}; {len(timed)} rates of 8")
    calls = 1 + BENCH_SCAN  # a mode's calls: its warm-up and the timed ones
    # 4 train (the Swin-L one included) and 3 serving modes, 12 (+ 12) a
    # call, and the window-32 train step under remat, 24 + 12
    want = expected(staged({"msda_fwd": 9 * MSDA_PER_FORWARD * calls,
                            "msda_bwd": 5 * MSDA_PER_FORWARD * calls}))
    if counts != want:
        raise AssertionError(f"[bench] launches {counts}, expected {want}")
    for line in lines:
        log(f"[bench] {line} ({card})")
    log(f"[bench] UVHAND_BENCH_SCAN={BENCH_SCAN}: launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}; phase 17 took "
        f"{time.perf_counter() - t_phase:.2f} s of wall clock")
    return counts


# ------------------------------------------------------------ 18-19. DINO

#: the DINO variant as the CLI builds it (`--modelname dino --two_stage`):
#: tied heads, CDN queries (dn_number 100: 198), look-forward-twice
DINO = dict(dino_variant=True, use_dn=True, look_forward_twice=True)
DINO_BATCHES, DINO_STEPS, CONVNEXT_STEPS = 2, 3, 2


def dn_call_line(timed, btimed, card):
    """K1's and K3's (K2's in bf16) device ms of one decoder call of the DINO
    train step (Lq 498) beside its byte bound, from phases 3 and 3b."""
    for dtype in ("fp32", "bf16"):
        case = f"dn decoder {dtype}"
        fwd, bwd = timed[case]["staged"], btimed[case]["staged"]
        log(f"[dino] one decoder call at Lq {DN_LQ} (B={BATCH}, {dtype}): msda_fwd_staged device "
            f"{ms_or_not(fwd['device_ms'])} ms (events {fwd['ms']:.4f}) against a "
            f"{fwd['bound_ms']:.4f} ms {fwd['bound_by']} bound; msda_bwd_staged device "
            f"{ms_or_not(bwd['device_ms'])} ms (events {bwd['ms']:.4f}) against "
            f"{bwd['bound_ms']:.4f} ms ({bwd['bound_by']}) ({card})")


def dino_phase(world, batches, train_batches, card):
    """Phase 18: DINO_4scale at full width (R50, 224x224, d=256, 8 heads,
    6+6 layers, FFN 1024, 300 queries, 4 levels x 4 points, dn_number 100),
    float32 and bf16 compute: 2 serving batches (12 staged forward launches
    each, no CDN in eval mode) held end to end against the plain MSDA run; a
    train pass with the kernels against the same pass on the plain versions
    from the same weights with one injected CDN draw (every loss, the
    `*_dn` terms included, within 1e-4; gradients within 1e-3 / 5e-2 of
    each tensor's max); 3 train steps of `make_fused_train_step` (the
    decoder's 6 calls at Lq 498, 12 + 12 staged launches a step, no other
    kernel, `label_enc` moves, everything finite); a profiled train step.
    Returns {tag: (serving launches, training launches)}."""
    t_phase = time.perf_counter()
    counts = {}
    for tag, dtype, grad_tol in (("dino fp32", torch.float32, 1e-3),
                                 ("dino bf16", torch.bfloat16, 5e-2)):
        model = build_model(**DINO, compute_dtype=dtype)
        rows, _, serve = main_path_phase(model, world, batches[:DINO_BATCHES], card, tag)
        e2e_phase(model, world, batches[0], rows[0], tag)
        train_ab_phase(model, world, train_batches[0], grad_tol=grad_tol, tag=tag)
        times, train = train_phase(model, world, train_batches[:DINO_STEPS], card, tag)
        log(f"[dino] {tag}: steady train step {np.median(times[1:]) * 1e3:.3f} ms "
            f"({BATCH / np.median(times[1:]):.1f} frames/s, B={BATCH}, {card})")
        opt = create_optimizer(model)
        step = engine.make_fused_train_step(
            model, *world, opt, img_res=IMG_RES,
            generator=torch.Generator(device="cuda").manual_seed(SEED))
        profile_line(f"{tag} train step", lambda: step(train_batches[1]))
        counts[tag] = (serve, train)
        del model, opt, step
        torch.cuda.empty_cache()
    log(f"[dino] phase 18 took {time.perf_counter() - t_phase:.2f} s of wall clock")
    return counts


def convnext_phase(world, batches, train_batches, card):
    """Phase 19: the DINO model on the ConvNeXt-XL backbone (depths
    3/3/27/3, dims 256..2048), float32: one serving batch and CONVNEXT_STEPS
    train steps at B=16 with the launch checks of phase 18, and the peak
    device memory of the steps. Returns (serving launches, training
    launches)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    model = build_model(**DINO, backbone="convnext_xlarge_22k")
    n = sum(p.numel() for p in model.parameters())
    _, _, serve = main_path_phase(model, world, batches[:1], card, "dino convnext")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, train = train_phase(model, world, train_batches[:CONVNEXT_STEPS], card,
                               "dino convnext")
    peak = torch.cuda.max_memory_allocated()
    log(f"[convnext] DINO on ConvNeXt-XL ({n / 1e6:.1f}M parameters), fp32, B={BATCH}: train "
        f"steps {', '.join(f'{t * 1e3:.1f}' for t in times)} ms, peak device memory "
        f"{peak / 2**30:.3f} GiB allocated ({card})")
    del model
    torch.cuda.empty_cache()
    log(f"[convnext] phase 19 took {time.perf_counter() - t_phase:.2f} s of wall clock")
    return serve, train


def dino_cli_phase(card):
    """The CLI with `--modelname dino` (fp32) on phase 13's synthetic root:
    an epoch of 2 `--debug` steps and its eval (2 batches), then `--eval
    --resume` of its checkpoint with the default metrics, whose scores must
    equal the in-process eval's; 12 staged forward launches a batch and
    12 + 12 a step, no other kernel. Returns the launches of both runs."""
    t_phase = time.perf_counter()
    data_dir = os.path.join(CLI_DIR, "data")
    out = os.path.join(CLI_DIR, "dino")
    parse = cli.get_args_parser().parse_args
    seq_batches = CLI_SEQS * CLI_VIEWS * -(-CLI_FRAMES // BATCH)
    runs, res = {}, {}
    for tag, argv, want in (
            ("dino train epoch", cli_argv(data_dir, out, "--num_debug", "2", "--modelname",
                                          "dino"),
             expected(staged({"msda_fwd": 2 * MSDA_PER_FORWARD, "msda_bwd": MSDA_PER_FORWARD}),
                      2)),
            ("dino eval --resume", cli_argv(data_dir, out + "_eval", "--num_debug", "2",
                                            "--modelname", "dino", "--eval", "--resume",
                                            os.path.join(out, "0")),
             expected(SERVE, 2 + seq_batches))):
        reset_counts()
        t0 = time.perf_counter()
        res[tag] = cli.main(parse(argv))
        torch.cuda.synchronize()
        runs[tag] = read_counts()
        if runs[tag] != want:
            raise AssertionError(f"[dino-cli] {tag}: launches {runs[tag]}, expected {want}")
        log(f"[dino-cli] {tag}: wall clock {time.perf_counter() - t0:.2f} s, launches "
            f"{json.dumps({k: v for k, v in runs[tag].items() if v})} ({card})")
    epoch = res["dino train epoch"]["epochs"][0]
    resumed = res["dino eval --resume"]["scores"][0]
    for k, v in epoch["scores"].items():
        if not (v == resumed[k] or (np.isnan(v) and np.isnan(resumed[k]))):
            raise AssertionError(f"[dino-cli] {k}: resumed eval {resumed[k]} != in-process {v}")
    bad = sorted(k for k, v in {**epoch["stats"], **resumed}.items() if not np.isfinite(v))
    if bad:
        raise AssertionError(f"[dino-cli] scores not finite: {bad}")
    log(f"[dino-cli] losses {json.dumps(epoch['stats'])}; the resumed eval's scores equal the "
        f"in-process eval's: {json.dumps(resumed)}; took {time.perf_counter() - t_phase:.2f} s")
    return runs


# ------------------------------------------------------------ 20. temporal

#: phase 20's train configurations: (tag, compute type, temporal head,
#: split_window, gradient tolerance of the kernel-against-plain pass)
TEMPORAL = (("fp32 lstm split", torch.float32, "lstm", True, 1e-3),
            ("fp32 vivit centre", torch.float32, "vivit", False, 1e-3),
            ("bf16 lstm split", torch.bfloat16, "lstm", True, 5e-2),
            ("bf16 vivit centre", torch.bfloat16, "vivit", False, 5e-2))
#: the frames the train windows are centred on: the A/B pass's, then a step's each
TEMPORAL_CENTRES = (21, 16, 26, 36)
TEMPORAL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                            "temporal_smoke")
#: a loss term of each kind that the temporal head's refined parameters add
TEMPORAL_TERMS = ("loss/mano/pose/r/temporal", "loss/cd/temporal", "loss/object/rot/temporal")


def temporal_windows():
    """Window batches of TEMPORAL_WINDOW frames through the data path, from a
    synthetic ARCTIC root of TEMPORAL_WINDOW + 22 frames (one sequence, one
    view, the object GT posed from the synthetic bank): for each frame of
    TEMPORAL_CENTRES the `TempoTrainDataset` window centred on it (clipped to
    [10, n - 11]) with every frame's targets ("split") and with the centre
    frame's ("centre", `center_index`), and the two `WindowDataset` windows
    ("serve", the second padded with its last frame). Windows are decoded in
    a thread pool."""
    from concurrent.futures import ThreadPoolExecutor

    shutil.rmtree(TEMPORAL_DIR, ignore_errors=True)
    root = os.path.join(TEMPORAL_DIR, "arctic")
    bank = objects.synthetic_object_bank(2, device="cpu")
    arctic.make_synthetic_root(root, num_seqs=1, frames=TEMPORAL_WINDOW + 22, views=1,
                               seed=SEED, obj_bank=bank)
    ds = arctic.ArcticDataset(root, "p1", "train", kp3d_cano=bank.kp_bottom.numpy())
    wds = arctic.WindowDataset(ds, TEMPORAL_WINDOW)
    jobs = {("serve", i): (wds, i, arctic.collate_windows) for i in range(len(wds))}
    for split in (True, False):
        tds = arctic.TempoTrainDataset(ds, TEMPORAL_WINDOW, split_window=split)
        collate = functools.partial(arctic.collate_tempo_train, split_window=split)
        for i, centre in enumerate(TEMPORAL_CENTRES):
            jobs[("split" if split else "centre", i)] = (tds, centre, collate)
    with ThreadPoolExecutor(8) as pool:
        done = {key: pool.submit(lambda d, i, c: c([d[i]]), *job) for key, job in jobs.items()}
        out = {}
        for (name, i), f in sorted(done.items()):
            out.setdefault(name, []).append(f.result())
    return out


def temporal_phase(world, card):
    """Phase 20: arctic_sf at full width with each temporal head over one
    window of TEMPORAL_WINDOW frames a batch (`temporal_windows`), fp32 and
    bf16 (`TEMPORAL`): a train pass with the kernels against the plain MSDA
    versions (every loss, the `/temporal` terms included, within 1e-4;
    gradients within 1e-3 / 5e-2 of each tensor's max), 3 steps of
    `make_fused_train_step` (12 + 12 staged launches a step, no other
    kernel), the steady step ms and frames/s, the peak device memory with
    remat off and (lstm) on (24 + 12 a remat step); the fp32 lstm model
    serves the 2 `WindowDataset` windows (12 staged launches a batch, held
    end to end against the plain run) and a train step of it is profiled;
    then SmoothNet: 3 `make_smoothnet_train_step` steps of an
    `ArcticSmoother(TEMPORAL_WINDOW)` behind a frozen fp32 arctic_sf (12
    forward launches a step, no backward; the base bit-identical after, the
    smoother moved). Returns {path: launches}."""
    from uvhand_tpu_torch.train import smoothnet_driver

    t0 = time.perf_counter()
    data = temporal_windows()
    log(f"[temporal] {len(data['split']) + len(data['centre']) + len(data['serve'])} windows of "
        f"{TEMPORAL_WINDOW} frames decoded in {time.perf_counter() - t0:.2f} s")
    T = TEMPORAL_WINDOW
    counts = {}
    for tag, dtype, kind, split, grad_tol in TEMPORAL:
        batches = data["split" if split else "centre"]
        model = build_model(compute_dtype=dtype, temporal_head=kind, temporal_window=T)
        train_ab_phase(model, world, batches[0], grad_tol=grad_tol, tag=f"temporal {tag}",
                       require=TEMPORAL_TERMS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, counts[f"train_temporal_{tag.replace(' ', '_')}"] = train_phase(
            model, world, batches[1:], card, f"temporal {tag}", frames=T)
        peak = torch.cuda.max_memory_allocated()
        steady = float(np.median(times[1:]))
        log(f"[temporal] {tag}: steady train step {steady * 1e3:.3f} ms ({T / steady:.1f} "
            f"frames/s, one window of {T} frames), peak device memory {peak / 2**30:.3f} GiB "
            f"allocated over its steps, remat off ({card})")
        if tag == "fp32 lstm split":
            rows, _, counts["serve_temporal_fp32_lstm"] = main_path_phase(
                model, world, data["serve"], card, f"temporal {tag}", frames=T)
            e2e_phase(model, world, data["serve"][0], rows[0], f"temporal {tag}")
            step = engine.make_fused_train_step(
                model, *world, create_optimizer(model), img_res=IMG_RES,
                generator=torch.Generator(device="cuda").manual_seed(SEED))
            profile_line(f"temporal {tag} train step", lambda: step(batches[1]))
            del step
        del model
        torch.cuda.empty_cache()
        if kind == "lstm":
            model = build_model(compute_dtype=dtype, temporal_head=kind, temporal_window=T,
                                remat=True)
            step = engine.make_fused_train_step(
                model, *world, create_optimizer(model), img_res=IMG_RES,
                generator=torch.Generator(device="cuda").manual_seed(SEED))
            step(batches[1])  # warm-up: the optimizer's state
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t1 = time.perf_counter()
            step(batches[2])
            torch.cuda.synchronize()
            dt, peak = time.perf_counter() - t1, torch.cuda.max_memory_allocated()
            remat = read_counts()
            want = expected(staged({"msda_fwd": 2 * MSDA_PER_FORWARD,
                                    "msda_bwd": MSDA_PER_FORWARD}))
            if remat != want:
                raise AssertionError(f"[temporal] {tag} remat step: launches {remat}, "
                                     f"expected {want}")
            log(f"[temporal] {tag} remat on: a step {dt * 1e3:.3f} ms, peak device memory "
                f"{peak / 2**30:.3f} GiB allocated; launches "
                f"{json.dumps({k: v for k, v in remat.items() if v})} ({card})")
            del model, step
            torch.cuda.empty_cache()

    base = build_model()
    smoother, opt = smoothnet_driver.create_smoother_state(
        T, lr=2e-4, generator=torch.Generator().manual_seed(SEED), device="cuda")
    step = smoothnet_driver.make_smoothnet_train_step(
        base, smoother, opt, *world, img_res=IMG_RES,
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    frozen = {k: v.clone() for k, v in base.state_dict().items()}
    before = {n: p.detach().clone() for n, p in smoother.named_parameters()}
    reset_counts()
    for i in range(3):
        launched_before = read_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ld = step(data["serve"][0])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        delta = {k: v - launched_before[k] for k, v in read_counts().items()}
        vals = {k: float(v) for k, v in ld.items()}
        log(f"[smoothnet] step {i}: {dt * 1e3:.3f} ms ({T / dt:.1f} frames/s, one window of {T} "
            f"frames, the base frozen, {card}); losses {json.dumps(vals)}")
        if delta != expected(SERVE) or not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"[smoothnet] step {i}: launches {delta}, losses {vals}")
    counts["smoothnet"] = read_counts()
    moved = [n for n, p in smoother.named_parameters() if not torch.equal(p, before[n])]
    if any(not torch.equal(v, frozen[k]) for k, v in base.state_dict().items()):
        raise AssertionError("[smoothnet] the frozen base model moved")
    if len(moved) != len(before):
        raise AssertionError(f"[smoothnet] {len(before) - len(moved)} smoother tensors did not "
                             f"move")
    log(f"[smoothnet] ArcticSmoother({T}): {sum(p.numel() for p in before.values()) / 1e6:.2f}M "
        f"parameters, every tensor moved; the base's {len(frozen)} tensors bit-identical; "
        f"launches {json.dumps({k: v for k, v in counts['smoothnet'].items() if v})}")
    del base, smoother, opt, step
    torch.cuda.empty_cache()
    return counts


def temporal_cli_phase(card):
    """The temporal routes of the CLI on phase 13's root, window 3, full
    width: `--method arctic_lstm --temporal_head lstm`, an epoch of 2 steps
    (5 windows of 3 frames each, the centre frames' targets) and its eval (2
    batches), then `--eval --resume` of its checkpoint (the sequence pass
    included), whose scores must equal the in-process eval's;
    `--train_smoothnet` behind phase 13's fp32 checkpoint, an epoch of 2
    steps, then `--smooth_resume` of its smoother. 12 staged forward
    launches a batch or smoothnet step, 12 + 12 a train step, no other
    kernel. Returns the launches of each run."""
    data_dir = os.path.join(CLI_DIR, "data")
    out, sm = os.path.join(CLI_DIR, "lstm"), os.path.join(CLI_DIR, "smoothnet")
    parse = cli.get_args_parser().parse_args
    seq_batches = CLI_SEQS * CLI_VIEWS * -(-CLI_FRAMES // BATCH)
    head = ("--method", "arctic_lstm", "--window_size", "3", "--temporal_head", "lstm")
    smooth = ("--train_smoothnet", "--window_size", "3", "--resume",
              os.path.join(CLI_DIR, "out", "0"))
    runs, res = {}, {}
    for tag, argv, want in (
            ("lstm train epoch", cli_argv(data_dir, out, "--num_debug", "2", *head),
             expected(staged({"msda_fwd": 2 * MSDA_PER_FORWARD, "msda_bwd": MSDA_PER_FORWARD}),
                      2)),
            ("lstm eval --resume", cli_argv(data_dir, out + "_eval", "--num_debug", "2", *head,
                                            "--eval", "--resume", os.path.join(out, "0")),
             expected(SERVE, 2 + seq_batches)),
            ("smoothnet epoch", cli_argv(data_dir, sm, "--num_debug", "2", *smooth),
             expected(SERVE, 2)),
            ("smoothnet --smooth_resume", cli_argv(data_dir, sm + "_resumed", "--num_debug", "2",
                                                   *smooth, "--smooth_resume",
                                                   os.path.join(sm, "0")),
             expected(SERVE, 2))):
        reset_counts()
        t0 = time.perf_counter()
        res[tag] = cli.main(parse(argv))
        torch.cuda.synchronize()
        runs[tag] = read_counts()
        if runs[tag] != want:
            raise AssertionError(f"[temporal-cli] {tag}: launches {runs[tag]}, expected {want}")
        log(f"[temporal-cli] {tag}: wall clock {time.perf_counter() - t0:.2f} s, launches "
            f"{json.dumps({k: v for k, v in runs[tag].items() if v})} ({card})")
    epoch = res["lstm train epoch"]["epochs"][0]
    resumed = res["lstm eval --resume"]["scores"][0]
    for k, v in epoch["scores"].items():
        if not (v == resumed[k] or (np.isnan(v) and np.isnan(resumed[k]))):
            raise AssertionError(f"[temporal-cli] {k}: resumed eval {resumed[k]} != "
                                 f"in-process {v}")
    smoothed = [res[t]["smoothnet"][0] for t in ("smoothnet epoch", "smoothnet --smooth_resume")]
    bad = sorted(k for k, v in {**epoch["stats"], **resumed}.items() if not np.isfinite(v))
    if bad or any(e["steps"] != 2 or not np.isfinite(e["losses"]["total"]) for e in smoothed):
        raise AssertionError(f"[temporal-cli] not finite: {bad}, smoothnet {smoothed}")
    log(f"[temporal-cli] lstm losses {json.dumps(epoch['stats'])}; the resumed eval's scores "
        f"equal the in-process eval's: {json.dumps(resumed)}; smoothnet losses "
        f"{json.dumps([e['losses'] for e in smoothed])}")
    return runs


# ------------------------------------------------------------ 21. Swin-L

SWIN = "swin_L_384_22k"
SWIN_BATCHES, SWIN_STEPS = 2, 3


def swin_phase(world, batches, train_batches, card):
    """Phase 21: arctic_sf (two-stage, box refinement, R50 swapped for the
    Swin-L of `swin_L_384_22k`: embed 192, depths 2/2/18/2, window 12) at
    full width, float32 and bf16 compute: SWIN_BATCHES serving batches (12
    staged forward launches each) held end to end against the plain MSDA
    run; a train pass against the plain versions from the same weights and
    generator seed (losses within 1e-4; gradients within 1e-3 / 5e-2 of
    each tensor's max); SWIN_STEPS train steps (12 + 12 staged launches a
    step, no other kernel), the steady step ms, frames/s and peak device
    memory; one step with remat on (24 + 12) and its peak; a profiled step's
    device busy share. Returns {tag: (serving launches, training launches)}."""
    t_phase = time.perf_counter()
    counts = {}
    for tag, dtype, grad_tol in (("swin fp32", torch.float32, 1e-3),
                                 ("swin bf16", torch.bfloat16, 5e-2)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = build_model(backbone=SWIN, compute_dtype=dtype)
        n_bb = sum(p.numel() for p in model.body.parameters())
        log(f"[swin] {tag}: built in {time.perf_counter() - t0:.2f} s, "
            f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M parameters "
            f"({n_bb / 1e6:.1f}M in the Swin)")
        rows, _, serve = main_path_phase(model, world, batches[:SWIN_BATCHES], card, tag)
        e2e_phase(model, world, batches[0], rows[0], tag)
        train_ab_phase(model, world, train_batches[0], grad_tol=grad_tol, tag=tag)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, train = train_phase(model, world, train_batches[:SWIN_STEPS], card, tag)
        peak = torch.cuda.max_memory_allocated()
        steady = float(np.median(times[1:]))
        log(f"[swin] {tag}: steady train step {steady * 1e3:.3f} ms ({BATCH / steady:.1f} "
            f"frames/s, B={BATCH}), peak device memory {peak / 2**30:.3f} GiB allocated over its "
            f"steps, remat off ({card})")
        step = engine.make_fused_train_step(
            model, *world, create_optimizer(model), img_res=IMG_RES,
            generator=torch.Generator(device="cuda").manual_seed(SEED))
        profile_line(f"{tag} train step", lambda: step(train_batches[1]))
        model.transformer.remat = True
        step(train_batches[2])  # warm-up of the remat path
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t1 = time.perf_counter()
        step(train_batches[0])
        torch.cuda.synchronize()
        dt, peak = time.perf_counter() - t1, torch.cuda.max_memory_allocated()
        remat = read_counts()
        want = expected(staged({"msda_fwd": 2 * MSDA_PER_FORWARD, "msda_bwd": MSDA_PER_FORWARD}))
        if remat != want:
            raise AssertionError(f"[swin] {tag} remat step: launches {remat}, expected {want}")
        log(f"[swin] {tag} remat on: a step {dt * 1e3:.3f} ms, peak device memory "
            f"{peak / 2**30:.3f} GiB allocated; launches "
            f"{json.dumps({k: v for k, v in remat.items() if v})} ({card})")
        counts[tag] = (serve, train)
        del model, step
    torch.cuda.empty_cache()
    log(f"[swin] phase 21 took {time.perf_counter() - t_phase:.2f} s of wall clock")
    return counts


def resumed_cli_runs(name, runs_argv, check_scores=True):
    """Each (tag, argv, expected launches) of `runs_argv` through
    `cli.main.main`, launches checked; the first run's epoch scores must
    equal the second's (`--eval --resume`) exactly, and every number be
    finite. Returns ({tag: launches}, {tag: result})."""
    parse = cli.get_args_parser().parse_args
    runs, res = {}, {}
    for tag, argv, want in runs_argv:
        reset_counts()
        t0 = time.perf_counter()
        res[tag] = cli.main(parse(argv))
        torch.cuda.synchronize()
        runs[tag] = read_counts()
        if runs[tag] != want:
            raise AssertionError(f"[{name}] {tag}: launches {runs[tag]}, expected {want}")
        log(f"[{name}] {tag}: wall clock {time.perf_counter() - t0:.2f} s, launches "
            f"{json.dumps({k: v for k, v in runs[tag].items() if v})}")
    (train, resume) = [t for t, _, _ in runs_argv]
    epoch, resumed = res[train]["epochs"][0], res[resume]["scores"][0]
    for k, v in epoch["scores"].items():
        if not (v == resumed[k] or (np.isnan(v) and np.isnan(resumed[k]))):
            raise AssertionError(f"[{name}] {k}: resumed eval {resumed[k]} != in-process {v}")
    bad = sorted(k for k, v in epoch["stats"].items() if not np.isfinite(v))
    if bad:
        raise AssertionError(f"[{name}] losses not finite: {bad}")
    log(f"[{name}] losses {json.dumps(epoch['stats'])}; the resumed eval's scores equal the "
        f"in-process eval's: {json.dumps(resumed)}")
    return runs, res


def swin_cli_phase(card):
    """The CLI with `--backbone swin_L_384_22k` (fp32) on phase 13's root: an
    epoch of 2 `--debug` steps and its eval (2 batches), then `--eval
    --resume` of its checkpoint with the default metrics; 12 staged forward
    launches a batch and 12 + 12 a step, no other kernel."""
    t_phase = time.perf_counter()
    data_dir = os.path.join(CLI_DIR, "data")
    out = os.path.join(CLI_DIR, "swin")
    seq_batches = CLI_SEQS * CLI_VIEWS * -(-CLI_FRAMES // BATCH)
    runs, _ = resumed_cli_runs("swin-cli", (
        ("swin train epoch", cli_argv(data_dir, out, "--num_debug", "2", "--backbone", SWIN),
         expected(staged({"msda_fwd": 2 * MSDA_PER_FORWARD, "msda_bwd": MSDA_PER_FORWARD}), 2)),
        ("swin eval --resume", cli_argv(data_dir, out + "_eval", "--num_debug", "2",
                                        "--backbone", SWIN, "--eval", "--resume",
                                        os.path.join(out, "0")),
         expected(SERVE, 2 + seq_batches))))
    log(f"[swin-cli] took {time.perf_counter() - t_phase:.2f} s ({card})")
    return runs


# ------------------------------------------------------------ 22. AssemblyHands

COCO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "coco_smoke")
#: images of each synthetic COCO root (train and val list the same ones)
COCO_IMAGES = 64
#: the AssemblyHands decoder's calls: 3 queries (left, right, object)
ASSEMBLY_LQ = 3
ASSEMBLY_BATCHES, ASSEMBLY_STEPS = 2, 3


def coco_roots():
    """Synthetic AssemblyHands and H2O roots (`make_synthetic_coco_root`,
    480x640 images) under build/coco_smoke/data, and from the AssemblyHands
    one batches of BATCH through `CocoHandsDataset` and `collate`: serving
    batches of the val split, train batches of the augmented train split."""
    from uvhand_tpu_torch.data.coco_hands import CocoHandsDataset, collate, \
        make_synthetic_coco_root

    shutil.rmtree(COCO_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    for i, name in enumerate(("AssemblyHands", "H2O")):
        make_synthetic_coco_root(os.path.join(COCO_DIR, "data", name), n_images=COCO_IMAGES,
                                 seed=SEED + i)
    root = os.path.join(COCO_DIR, "data", "AssemblyHands")
    val = CocoHandsDataset(root, "val", img_res=IMG_RES)
    train = CocoHandsDataset(root, "train", img_res=IMG_RES, aug=True, seed=SEED)
    serve = [collate([val[j] for j in range(i * BATCH, (i + 1) * BATCH)])
             for i in range(ASSEMBLY_BATCHES)]
    steps = [collate([train[j % COCO_IMAGES] for j in range(i * BATCH, (i + 1) * BATCH)])
             for i in range(ASSEMBLY_STEPS + 1)]
    log(f"[assembly] two synthetic COCO roots of {COCO_IMAGES} images written and "
        f"{len(serve) + len(steps)} batches of {BATCH} read in {time.perf_counter() - t0:.2f} s")
    return serve, steps


def assembly_phase(card):
    """Phase 22: `AssemblyDETR` at full width (R50, 224x224, d=256, 8 heads,
    6+6 layers, FFN 1024, 3 queries; float32, as the model always runs) on
    batches of BATCH from a synthetic AssemblyHands root: ASSEMBLY_BATCHES
    serving batches through `engine.make_assembly_eval_step` (12 staged
    forward launches each: 6 encoder calls at Lq 1045, 6 decoder calls at
    Lq 3) held end to end against the plain MSDA run; a train pass (dropout
    on, one generator seed) against the plain versions (every criterion
    term within 1e-4, gradients within 1e-3 of each tensor's max);
    ASSEMBLY_STEPS steps of `engine.make_assembly_train_step` (12 + 12
    staged launches a step, no other kernel, every group moving), the
    steady step ms, frames/s and peak memory, and a profiled step. Returns
    (serving launches, training launches)."""
    from uvhand_tpu_torch.models.assembly import AssemblyDETR, assembly_criterion

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    serve_batches, train_batches = coco_roots()
    model = AssemblyDETR(generator=torch.Generator().manual_seed(SEED), device="cuda")
    log(f"[assembly] AssemblyDETR: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
        f"parameters")
    step = engine.make_assembly_eval_step(model)
    reset_counts()
    preds = []
    for i, batch in enumerate(serve_batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        preds.append(out["pred"])
        log(f"[serve] assembly batch {i}: {dt * 1e3:.3f} ms, {BATCH / dt:.1f} frames/s "
            f"(B={BATCH}, fp32, {card})")
        if out["pred"].shape != (BATCH, 3, 63) or not bool(torch.isfinite(out["pred"]).all()):
            raise AssertionError(f"[assembly] batch {i}: predictions {out['pred'].shape} not "
                                 f"finite or of the wrong shape")
    serve = read_counts()
    if serve != expected(SERVE, len(serve_batches)):
        raise AssertionError(f"[assembly] serving launches {serve}, expected "
                             f"{expected(SERVE, len(serve_batches))}")
    from uvhand_tpu_torch.evaluation.coco_eval import assembly_keypoint_metrics

    scores = assembly_keypoint_metrics(
        torch.cat(preds).cpu().numpy(), np.concatenate([b["keypoints63"] for b in serve_batches]),
        np.concatenate([b["target_valid"] for b in serve_batches]), (IMG_RES, IMG_RES))
    log(f"[serve] assembly launches {json.dumps({k: v for k, v in serve.items() if v})}; scores "
        f"(random weights) {json.dumps(scores)}")

    # end to end against the plain MSDA run
    images = torch.as_tensor(serve_batches[0]["images"], device="cuda")
    with torch.inference_mode():
        out_k = model(images)["stacked"]
        set_msda_impl(model, "torch")
        try:
            out_p = model(images)["stacked"]
            pred_p = step(serve_batches[0])["pred"]
        finally:
            set_msda_impl(model, "auto")
    for k in ("pred_logits", "pred_keypoints"):
        d = float((out_k[k] - out_p[k]).abs().max())
        log(f"[e2e] assembly {k}: kernel vs plain max_abs_diff={d:.3e} (tol 1e-4)")
        if d > 1e-4:
            raise AssertionError(f"[assembly] kernel and plain runs disagree on {k}")
    d = float((preds[0] - pred_p).abs().max())
    log(f"[e2e] assembly selected keypoints: kernel vs plain max_abs_diff={d:.3e} (tol 1e-4)")
    if d > 1e-4:
        raise AssertionError("[assembly] kernel and plain runs select other keypoints")

    # train pass, kernels against the plain versions
    tb = engine.to_device(train_batches[0], "cuda", engine.COCO_KEYS)
    params = dict(model.named_parameters())
    runs = {}
    model.train()
    try:
        for impl in ("auto", "torch"):
            set_msda_impl(model, impl)
            model.zero_grad(set_to_none=True)
            out = model(tb["images"], torch.Generator(device="cuda").manual_seed(SEED))
            total, ld = assembly_criterion(out, tb["labels"], tb["keypoints63"],
                                           tb["target_valid"])
            total.backward()
            runs[impl] = ({k: float(v.detach()) for k, v in ld.items()},
                          {n: p.grad.clone() for n, p in params.items() if p.grad is not None})
    finally:
        set_msda_impl(model, "auto")
        model.zero_grad(set_to_none=True)
    (ld_k, g_k), (ld_p, g_p) = runs["auto"], runs["torch"]
    bad = [k for k in ld_p if not abs(ld_k[k] - ld_p[k]) <= 1e-4 * abs(ld_p[k]) + 1e-6]
    worst, worst_name = 0.0, ""
    for n, gp in g_p.items():
        rel = float((g_k[n] - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, n
    log(f"[train-ab] assembly losses {json.dumps(ld_k)} (plain {json.dumps(ld_p)}, tol 1e-4); "
        f"{len(g_p)} gradients, worst {worst:.3e} of its tensor's max ({worst_name}; tol 1e-3)")
    if bad or set(g_k) != set(g_p) or worst > 1e-3:
        raise AssertionError(f"[assembly] kernel and plain train passes disagree: {bad}, {worst}")

    # train steps
    opt = create_optimizer(model)
    train_step = engine.make_assembly_train_step(
        model, opt, generator=torch.Generator(device="cuda").manual_seed(SEED))
    labels = label_params(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for i, batch in enumerate(train_batches[1:]):
        old = {n: p.detach().clone() for n, p in params.items()}
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ld = train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        delta = {n: v - before[n] for n, v in read_counts().items()}
        vals = {k: float(v) for k, v in ld.items()}
        moved = {g: any(not torch.equal(p, old[n]) for n, p in params.items() if labels[n] == g)
                 for g in set(labels.values())}
        log(f"[train] assembly step {i}: {times[-1] * 1e3:.3f} ms, {BATCH / times[-1]:.1f} "
            f"frames/s (B={BATCH}, fp32, {card}); losses {json.dumps(vals)}, launches "
            f"{json.dumps({n: f'+{d}' for n, d in delta.items() if d})}, groups moved {moved}")
        if delta != expected(TRAIN) or not all(np.isfinite(v) for v in vals.values()) \
                or not vals["grad_norm"] > 0 or not all(moved.values()):
            raise AssertionError(f"[assembly] step {i}: launches {delta}, losses {vals}, "
                                 f"moved {moved}")
    train = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steady = float(np.median(times[1:]))
    log(f"[assembly] steady train step {steady * 1e3:.3f} ms ({BATCH / steady:.1f} frames/s, "
        f"B={BATCH}), peak device memory {peak / 2**30:.3f} GiB allocated ({card})")
    profile_line("assembly train step", lambda: train_step(train_batches[1]))
    profile_line("assembly serving batch", lambda: step(serve_batches[1]))
    del model, opt, train_step, step
    torch.cuda.empty_cache()
    log(f"[assembly] phase 22 took {time.perf_counter() - t_phase:.2f} s of wall clock")
    return serve, train


def coco_cli_phase(card):
    """The CLI's COCO-format route at full width on phase 22's roots, for
    `--dataset_file AssemblyHands` and `H2O`: an epoch of 2 `--debug` steps,
    its checkpoint and its eval (every val batch), then `--eval --resume` of
    the checkpoint, whose scores must equal the epoch's; 12 staged forward
    launches a batch and 12 + 12 a step, no other kernel."""
    t_phase = time.perf_counter()
    val_batches = -(-COCO_IMAGES // BATCH)
    runs = {}
    for name in ("AssemblyHands", "H2O"):
        out = os.path.join(COCO_DIR, name.lower())

        def argv(out_dir, *extra):
            return ["--dataset_file", name, "--coco_path", os.path.join(COCO_DIR, "data"),
                    "--output_dir", out_dir, "--batch_size", str(BATCH), "--val_batch_size",
                    str(BATCH), "--epochs", "1", "--debug", "--num_debug", "2",
                    "--num_workers", "8", "--seed", str(SEED), *extra]

        got, _ = resumed_cli_runs(f"{name.lower()}-cli", (
            (f"{name} train epoch", argv(out),
             expected(staged({"msda_fwd": 2 * MSDA_PER_FORWARD + val_batches * MSDA_PER_FORWARD,
                              "msda_bwd": 2 * MSDA_PER_FORWARD}))),
            (f"{name} eval --resume", argv(out + "_eval", "--eval", "--resume",
                                           os.path.join(out, "0")),
             expected(SERVE, val_batches))))
        runs.update(got)
    log(f"[coco-cli] took {time.perf_counter() - t_phase:.2f} s ({card})")
    return runs


def assembly_call_line(timed, btimed, card):
    """K1's and K3's device ms of one AssemblyHands decoder call (Lq 3
    against S 1045, B=16, float32) beside their bounds, from phases 3 and 3b."""
    fwd, bwd = timed["assembly decoder fp32"]["staged"], btimed["assembly decoder fp32"]["staged"]
    log(f"[assembly] one decoder call at Lq {ASSEMBLY_LQ} (B={BATCH}, fp32): msda_fwd_staged "
        f"device {ms_or_not(fwd['device_ms'])} ms (events {fwd['ms']:.4f}) against a "
        f"{fwd['bound_ms']:.4f} ms {fwd['bound_by']} bound, plain {fwd['plain_ms']:.4f} ms; "
        f"msda_bwd_staged device {ms_or_not(bwd['device_ms'])} ms (events {bwd['ms']:.4f}) "
        f"against {bwd['bound_ms']:.4f} ms ({bwd['bound_by']}), plain {bwd['plain_ms']:.4f} ms "
        f"({card})")


# ------------------------------------------------------------ main


# ------------------------------------------------- 23. the export routes

EXPORT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "export_smoke")
#: frames `--eval --visualization --debug` draws: --num_debug x --val_batch_size
VIS_FRAMES = 2 * BATCH


def export_phase(card):
    """Phase 23: the routes that export, on phase 13's root with its fp32
    checkpoint (out/0), arctic_sf at full width (R50, d=256, 6+6 layers,
    300 queries), each run with every count set to 0 just before it and
    read just after:
      1. the CLI's `--extraction_mode submit_pose --resume out/0`: the val
         split's ARCTIC submission in batches of 16 per sequence, 12 staged
         forward launches a batch and no other kernel; every file finite;
      2. `run_extraction` in this process on the same checkpoint, with the
         kernels and with the plain MSDA versions: the values before the
         float16 cast agree within 1e-4 of each tensor's max, and the
         kernel run's files equal the CLI's bit for bit;
      3. the CLI's `--extract`: the backbone's maps of the train split, no
         MSDA launch; then a `local_fm` model (`feature_type="local_fm"`,
         3 levels: S = 28^2 + 14^2 + 7^2 = 1029) fed the stored maps of 16
         frames: 12 staged forward launches a batch at the 3-level shape,
         its outputs equal to its plain MSDA run's within 1e-4, its batch
         ms;
      4. the CLI's `--eval --visualization --resume out/0`: 32 frames in
         batches of 4 (12 launches each), a PNG each and the OBJ meshes of
         the first 4.
    Returns {path: launches}."""
    from uvhand_tpu_torch.cli.extract_features import load_feature_maps
    from uvhand_tpu_torch.cli.extract_predicts import run_extraction
    from uvhand_tpu_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    data_dir = os.path.join(CLI_DIR, "data")
    root = os.path.join(data_dir, "arctic")
    resume = os.path.join(CLI_DIR, "out", "0")
    parse = cli.get_args_parser().parse_args
    kp3d = objects.synthetic_object_bank(2, device="cpu").kp_bottom.numpy()
    ds_val = arctic.ArcticDataset(root, "p1", "val", kp3d_cano=kp3d)
    per_seq = {}
    for n in ds_val.imgnames:
        per_seq[tuple(n.split("/")[-4:-2])] = per_seq.get(tuple(n.split("/")[-4:-2]), 0) + 1
    export_batches = sum(-(-n // BATCH) for n in per_seq.values())
    runs = {}

    def run(tag, argv, want):
        reset_counts()
        t0 = time.perf_counter()
        res = cli.main(parse(argv))
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"[export] {tag}: launches {counts}, expected {want}")
        log(f"[export] {tag}: wall clock {time.perf_counter() - t0:.2f} s, launches "
            f"{json.dumps({k: v for k, v in counts.items() if v})} ({card})")
        runs[tag] = counts
        return res

    def files(path, suffix):
        return sorted(os.path.relpath(os.path.join(d, f), path)
                      for d, _, fs in os.walk(path) for f in fs if f.endswith(suffix))

    # 1. the submission through the CLI
    res = run("--extraction_mode submit_pose", cli_argv(
        data_dir, os.path.join(EXPORT_DIR, "cli"), "--extraction_mode", "submit_pose",
        "--resume", resume), expected(SERVE, export_batches))
    sub = res["submission"]
    pts = files(sub, ".pt")
    if not pts or len(pts) != 10 * len({tuple(n.split("/")[-4:-1]) for n in ds_val.imgnames}):
        raise AssertionError(f"[export] {len(pts)} submission files")
    for name in pts:
        t = torch.load(os.path.join(sub, name), weights_only=False)
        if isinstance(t, torch.Tensor) and (t.dtype != torch.float16
                                            or not torch.isfinite(t.float()).all()):
            raise AssertionError(f"[export] {name}: {t.dtype}, finite {torch.isfinite(t).all()}")
    ms = res["timing"]["batch_ms"]
    log(f"[export] submission: {len(pts)} files for {len(ds_val)} frames of {len(per_seq)} "
        f"sequences, {export_batches} batches of {BATCH} (12 staged K1 launches each): batch ms "
        f"{', '.join(f'{x:.1f}' for x in ms)} (steady {np.median(ms[1:] or ms):.1f} ms: host decode, "
        f"forward, selection, extraction; B={BATCH}, fp32, {card})")

    # 2. the same export in this process, kernels against the plain versions
    args = parse(cli_argv(data_dir, EXPORT_DIR))
    model = cli.build_model(args, "cuda")
    ckpt.load_checkpoint(resume, model)
    ds = arctic.ArcticDataset(root, "p1", "val", kp3d_cano=kp3d, img_res=IMG_RES)
    kernel_vals, plain_vals = {}, {}
    run_extraction(model, ds, BATCH, os.path.join(EXPORT_DIR, "api"), float(IMG_RES),
                   results=kernel_vals)
    set_msda_impl(model, "torch")
    try:
        run_extraction(model, ds, BATCH, os.path.join(EXPORT_DIR, "plain"), float(IMG_RES),
                       results=plain_vals)
    finally:
        set_msda_impl(model, "auto")
    worst = 0.0
    for cam, cur in plain_vals.items():
        for k, v in cur.items():
            if isinstance(v, list):
                if kernel_vals[cam][k] != v:
                    raise AssertionError(f"[export] {cam} {k}: the frames differ")
                continue
            err = float(np.abs(kernel_vals[cam][k] - v).max()) / max(1.0, float(np.abs(v).max()))
            worst = max(worst, err)
            if not err <= 1e-4:
                raise AssertionError(f"[export] {cam} {k}: kernel vs plain {err:.3e} > 1e-4")
    for name in pts:
        a = torch.load(os.path.join(sub, name), weights_only=False)
        b = torch.load(os.path.join(EXPORT_DIR, "api", name), weights_only=False)
        if not (a == b if isinstance(a, list) else torch.equal(a, b)):
            raise AssertionError(f"[export] {name}: the CLI's file differs from run_extraction's")
    log(f"[export] run_extraction, kernels against the plain MSDA versions: values before the "
        f"float16 cast within {worst:.3e} of each tensor's max (tol 1e-4); the CLI's files "
        f"equal the kernel run's bit for bit")
    del model

    # 3. the backbone's maps, and a local_fm model fed from them
    res = run("--extract", cli_argv(data_dir, os.path.join(EXPORT_DIR, "extract"), "--extract"),
              expected({}, 0))
    stored = files(res["features"], ".pkl")
    ds_train = arctic.ArcticDataset(root, "p1", "train")
    if len(stored) != len(ds_train):
        raise AssertionError(f"[export] {len(stored)} stored maps for {len(ds_train)} frames")
    maps = load_feature_maps(os.path.join(data_dir, "pickle"), ds_train.imgnames[:BATCH])
    shapes = [m.shape for m in maps]
    if shapes != [(BATCH, h, w, c) for (h, w), c in zip(LOCAL_FM_LEVELS, (512, 1024, 2048))]:
        raise AssertionError(f"[export] stored maps {shapes}")
    fm_model = build_model(feature_type="local_fm", num_feature_levels=3)
    x = [torch.as_tensor(m, device="cuda") for m in maps]
    with torch.inference_mode():
        fm_model(x)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fm_model(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        if counts != expected(SERVE, 3):
            raise AssertionError(f"[export] local_fm forwards: launches {counts}")
        runs["local_fm serving batches"] = counts
        set_msda_impl(fm_model, "torch")
        ref = fm_model(x)
        set_msda_impl(fm_model, "auto")
    for k in ("pred_logits", "pred_hand_key", "pred_obj_key", "pred_mano_pose", "pred_obj_cam"):
        err = float((out["stacked"][k] - ref["stacked"][k]).abs().max())
        if not (torch.isfinite(out["stacked"][k]).all() and err <= 1e-4):
            raise AssertionError(f"[export] local_fm {k}: kernel vs plain {err:.3e}")
    log(f"[export] local_fm model (3 levels, S = 1029) on {len(stored)} stored maps' first "
        f"{BATCH} frames: forward ms {', '.join(f'{t:.1f}' for t in times)} (B={BATCH}, fp32, "
        f"{card}); 12 staged K1 launches a batch; outputs equal to its plain MSDA run's "
        f"within 1e-4")
    del fm_model

    # 4. the visualization route
    vis = os.path.join(EXPORT_DIR, "vis")
    frames = min(len(ds_val), VIS_FRAMES)
    run("--eval --visualization", cli_argv(data_dir, vis, "--num_debug", "2", "--eval",
                                           "--visualization", "--resume", resume),
        expected(SERVE, -(-frames // 4)))
    pngs, objs = files(os.path.join(vis, "vis"), ".png"), files(os.path.join(vis, "vis"), ".obj")
    if len(pngs) != frames or len(objs) != 12:
        raise AssertionError(f"[export] visualization wrote {len(pngs)} PNGs, {len(objs)} OBJs")
    log(f"[export] visualization: {len(pngs)} PNGs and {len(objs)} OBJs for {frames} frames in "
        f"batches of 4 (12 staged K1 launches each)")
    log(f"[export] phase 23 took {time.perf_counter() - t_phase:.2f} s of wall clock ({card})")
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 2

    # 1. card
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] {card}")
    log(f"[card] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    log(f"[card] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    # what the native image library (uvhand_tpu_torch/native/) needs to build
    log(f"[card] native image library's toolchain: g++ {shutil.which('g++')}, OpenCV 4 "
        f"headers {os.path.isdir('/usr/include/opencv4')}, jpeglib.h "
        f"{os.path.exists('/usr/include/jpeglib.h')} (without both headers "
        f"--native_loader on|fast raises with the compiler's message)")

    # 2. build
    t0 = time.perf_counter()
    msda_cuda.library()
    log(f"[build] {', '.join(src.name for src in msda_cuda.SOURCES)} built (one nvcc each, "
        f"together) and loaded in {time.perf_counter() - t0:.2f} s")
    for line in ptxas_lines(msda_cuda.ptxas_report()):
        log(f"[build] {line}")

    # 3. kernels against their plain versions
    timed, max_err = kernel_phase()
    btimed, bmax_err = backward_kernel_phase()
    ftimed, fmax_err = fac_kernel_phase()

    # 3d. the research entry points (S1, S2)
    t0 = time.perf_counter()
    research_numbers = research_phase()
    log(f"[ablation] phase 3d took {time.perf_counter() - t0:.2f} s of wall clock")

    # 3e. each op's general path (shapes beyond shared memory)
    general = general_path_phase()
    fac_general = general_path_phase(fac=True)

    # 3f. inputs the kernels do not take as they are, through the op
    unprepared = unprepared_inputs_phase()

    # 4. main path
    model, world = build_world("cuda")
    rng = np.random.default_rng(SEED)
    batches = [synthetic_batch(rng, world[2], BATCH) for _ in range(N_BATCHES)]
    gt_phase(world, batches[0])
    rows, _, serve_fp32 = main_path_phase(model, world, batches, card)

    # 5. the same batch with the plain MSDA version
    fp32_out = e2e_phase(model, world, batches[0], rows[0])

    # 6. where one batch's time goes
    profile_phase(model, world, batches[1])
    del model

    # 7-9. training, from the same seeded weights
    model, world = build_world("cuda")
    train_batches = [synthetic_batch(rng, world[2], BATCH) for _ in range(TRAIN_STEPS)]
    train_ab_phase(model, world, train_batches[0])
    _, train_fp32 = train_phase(model, world, train_batches[:FP32_TRAIN_STEPS], card)
    train_profile_phase(model, world, train_batches[1])
    del model

    def bf16_paths(tag, serve, train):
        """Phases 10-11 (or 12 under UVHAND_MSDA_FAC=1): the bf16 model
        serves, is held against its plain MSDA run, trains, and is profiled."""
        model, world = build_world("cuda", torch.bfloat16)
        rows, _, serve_counts = main_path_phase(model, world, batches, card, tag, serve)
        e2e_phase(model, world, batches[0], rows[0], tag)
        step = engine.make_eval_step(model, *world, img_res=IMG_RES)
        profile_line(f"{tag} serving batch", lambda: step(batches[1]))
        # bf16: a last-bit change of an atomic dvalue sum is a whole bf16 step
        train_ab_phase(model, world, train_batches[0], grad_tol=5e-2, tag=tag)
        _, train_counts = train_phase(model, world, train_batches, card, tag, train)
        train_step = engine.make_fused_train_step(
            model, *world, create_optimizer(model), img_res=IMG_RES,
            generator=torch.Generator(device="cuda").manual_seed(SEED))
        profile_line(f"{tag} train step", lambda: train_step(train_batches[1]))
        return serve_counts, train_counts

    # 10-11. bf16 serving and training through the gather kernels
    serve_bf16, train_bf16 = bf16_paths("bf16", SERVE, TRAIN)

    # 12. the same with the factorized formulation, and one float32 batch of it
    with fac_formulation():
        serve_fac, train_fac = bf16_paths("bf16 FAC", SERVE_FAC, TRAIN_FAC)
    serve_fac_fp32 = fac_fp32_phase(
        fp32_out, torch.as_tensor(batches[0]["images"], device="cuda"))

    # 13. the port's CLI on a synthetic ARCTIC root on disk
    cli_runs = cli_phase(card)

    # 14. the model and training options at full width; 15. remat's memory
    option_counts = options_phase(world, batches, train_batches, card)
    remat_memory_phase(world, rng, card)

    # 16. the CLI under torch.distributed.run, world size 1; 17. the bench
    torchrun_runs = launcher_phase(card)
    bench_counts = bench_phase(card)

    # 18. DINO_4scale, fp32 and bf16; 19. on ConvNeXt-XL; the CLI with --modelname dino
    dn_call_line(timed, btimed, card)
    dino_counts = dino_phase(world, batches, train_batches, card)
    convnext_counts = convnext_phase(world, batches, train_batches, card)
    dino_cli_runs = dino_cli_phase(card)

    # 20. the temporal variant: window-32 training and serving, SmoothNet, the CLI
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    temporal_counts = temporal_phase(world, card)
    temporal_cli_runs = temporal_cli_phase(card)
    log(f"[temporal] phase 20 took {time.perf_counter() - t0:.2f} s of wall clock")

    # 21. arctic_sf on Swin-L, fp32 and bf16, and the CLI with --backbone swin_L_384_22k
    t0 = time.perf_counter()
    swin_counts = swin_phase(world, batches, train_batches, card)
    swin_cli_runs = swin_cli_phase(card)
    log(f"[swin] phase 21 with its CLI runs took {time.perf_counter() - t0:.2f} s of wall clock")

    # 22. AssemblyHands at full width, and the CLI's COCO-format route
    t0 = time.perf_counter()
    assembly_call_line(timed, btimed, card)
    assembly_counts = assembly_phase(card)
    coco_cli_runs = coco_cli_phase(card)
    log(f"[assembly] phase 22 with its CLI runs took {time.perf_counter() - t0:.2f} s of wall "
        f"clock")

    # 23. the export routes: the ARCTIC submission, the backbone maps and a
    # local_fm model fed from them, the visualization
    export_runs = export_phase(card)

    def per_call(t, dtype, kind=None):
        # a forward or a backward calls its kernel 6 times at each of the two shapes
        enc, dec = f"encoder {dtype}", f"decoder {dtype}"
        if kind:
            t = {k: t[k][kind] for k in (enc, dec)}
        row = {key: None if None in (t[enc][key], t[dec][key])  # device time not measured
               else 6 * t[enc][key] + 6 * t[dec][key]
               for key in ("ms", "device_ms", "plain_ms", "bound_ms") if key in t[enc]}
        row["bound_by"] = "bytes" if {t[enc]["bound_by"], t[dec]["bound_by"]} == {"bytes"} \
            else "operations"
        return row

    log("[kernel] ms, plain_ms and bound_ms are per forward or backward of the model (6 encoder "
        "+ 6 decoder calls): float32 for the gather kernels (bf16 under *_bf16), bf16 for the "
        "factorized kernels (their path here; fp32 under *_fp32); launches are the CLI's (phase "
        "13, the users' entry point): its fp32 epoch (msda_fwd_staged, msda_bwd_staged: 4 steps "
        "and 4 eval batches) and its bf16 FAC epoch (msda_fac_*_staged: 2 steps and 2 eval "
        "batches), and phase 3e's general paths' (msda_*_general: arctic_sf's shapes launch none "
        "of them); launches_by_path gives every path's count (phase 14's options and the CLI's "
        "option runs included); *_enc_lite_call: one float32 call of enc_lite's low-resolution-"
        "only layers (Lq 261 against S 1045, B=16); *_dn_decoder_call(_bf16): one decoder call "
        "of the DINO train step (Lq 498: 300 + 198 CDN queries, B=16); *_temporal_call: one "
        "float32 encoder call of the temporal train step (its 32 window frames, Lq = S = 1045); "
        "*_assembly_call: one float32 decoder call of AssemblyDETR (Lq 3 against S 1045, B=16); "
        "msda_fwd_*_local_fm_call: one float32 encoder call of the local_fm model (3 levels, "
        "Lq = S = 1029, B=16); launches_by_path cli_extraction_mode, serve_local_fm (3 batches) "
        "and cli_visualization: phase 23's")

    log("[kernel] the research kernels' ms, plain_ms and bound_ms are per call at the TPU "
        "scripts' shapes, bf16 for the ablation's (the bench's default; fp32 beside it), float32 "
        "for the probes (probe_lane_slice_*: the MSDA call site's Q = 16 x 1048, both cases "
        "under cases, floor_ms an empty kernel on vec4's grid; probe_gather_*: its largest case, "
        "every case the kind takes under cases; the probes' ms, plain_ms, library_ms and "
        "floor_ms are device time from the profiler, the kinds the lower of two turns, "
        "launched_ms the time as launched from CUDA events); msda_onlyg_* and msda_xdot: from "
        "--kinds (ms: CUDA "
        "events as launched, for the onlyg kinds the lower of two medians in turns; device_ms: "
        "the profiler's device time a call, the wrapper's output fills included; *_fp32 "
        "beside); launches are phase 3d's (the research path: msda_onlyg_general none), 0 on "
        "every model path")

    def by_path(name):
        return {"serve_fp32": serve_fp32[name], "train_fp32": train_fp32[name],
                "serve_bf16": serve_bf16[name], "train_bf16": train_bf16[name],
                "serve_bf16_fac": serve_fac[name], "train_bf16_fac": train_fac[name],
                "serve_fp32_fac": serve_fac_fp32[name],
                "research": research_numbers["launches"][name], "general": general[name],
                "fac_general": fac_general[name], "unprepared": unprepared[name],
                "cli_fp32_train": cli_runs["fp32 train epoch"][name],
                "cli_fp32_eval": cli_runs["fp32 eval --resume out/0"][name],
                "cli_bf16_fac_train": cli_runs["bf16 FAC train epoch"][name],
                **{f"cli_{tag}": n[name] for tag, n in cli_runs.items()
                   if tag.startswith(("single-stage", "bf16-params"))},
                **{f"serve_{tag}": n[0][name] for tag, n in option_counts.items()},
                **{f"train_{tag}": n[1][name] for tag, n in option_counts.items()},
                "cli_torchrun_train": torchrun_runs["train"][name],
                "cli_torchrun_eval": torchrun_runs["eval --resume"][name],
                "bench": bench_counts[name],
                **{f"serve_{tag}": n[0][name] for tag, n in dino_counts.items()},
                **{f"train_{tag}": n[1][name] for tag, n in dino_counts.items()},
                "serve_dino_convnext": convnext_counts[0][name],
                "train_dino_convnext": convnext_counts[1][name],
                "cli_dino_train": dino_cli_runs["dino train epoch"][name],
                "cli_dino_eval": dino_cli_runs["dino eval --resume"][name],
                **{path: n[name] for path, n in temporal_counts.items()},
                **{f"cli_temporal_{tag.replace(' ', '_')}": n[name]
                   for tag, n in temporal_cli_runs.items()},
                **{f"serve_{tag.replace(' ', '_')}": n[0][name] for tag, n in swin_counts.items()},
                **{f"train_{tag.replace(' ', '_')}": n[1][name] for tag, n in swin_counts.items()},
                "cli_swin_train": swin_cli_runs["swin train epoch"][name],
                "cli_swin_eval": swin_cli_runs["swin eval --resume"][name],
                "serve_assembly": assembly_counts[0][name],
                "train_assembly": assembly_counts[1][name],
                **{f"cli_{tag.split()[0].lower()}_{'train' if 'train' in tag else 'eval'}": n[name]
                   for tag, n in coco_cli_runs.items()},
                "cli_extraction_mode": export_runs["--extraction_mode submit_pose"][name],
                "cli_extract": export_runs["--extract"][name],
                "serve_local_fm": export_runs["local_fm serving batches"][name],
                "cli_visualization": export_runs["--eval --visualization"][name]}

    def gather_row(op, kind, timed_, errs, launches, replaces):
        bf16 = per_call(timed_, "bf16", kind)
        lite = timed_["enc_lite fp32"][kind]  # one enc_lite low-resolution-only call
        window = timed_["temporal encoder fp32"][kind]  # one encoder call of a window step
        assembly = timed_["assembly decoder fp32"][kind]  # one AssemblyHands decoder call
        dn = {dt: timed_[f"dn decoder {dt}"][kind] for dt in ("fp32", "bf16")}
        return {"name": f"{op}_{kind}", "route": "cuda", "source": f"{src}{op}.cu",
                "replaces": replaces, "launches": launches, "launches_by_path": by_path(
                    f"{op}_{kind}"), "dtype": "float32", "max_abs_err": errs[kind],
                **per_call(timed_, "fp32", kind), "library_ms": None, "ms_bf16": bf16["ms"],
                "device_ms_bf16": bf16["device_ms"], "plain_ms_bf16": bf16["plain_ms"],
                "bound_ms_bf16": bf16["bound_ms"],
                **{f"{k}_enc_lite_call": lite[k]
                   for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
                **{f"{k}_dn_decoder_call{'' if dt == 'fp32' else '_bf16'}": dn[dt][k]
                   for dt in dn for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
                **{f"{k}_temporal_call": window[k]
                   for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
                **{f"{k}_assembly_call": assembly[k]
                   for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
                **({f"{k}_local_fm_call": timed_["local_fm encoder fp32"][kind][k]
                    for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
                   if "local_fm encoder fp32" in timed_ else {})}

    def fac_row(op, kind, key, launches, replaces):
        fp32 = per_call(ftimed[key], "fp32", kind)
        return {"name": f"{op}_{kind}", "route": "cuda", "source": f"{src}{op}.cu",
                "replaces": replaces, "launches": launches, "launches_by_path": by_path(
                    f"{op}_{kind}"), "dtype": "bfloat16", "max_abs_err": fmax_err[key][kind],
                **per_call(ftimed[key], "bf16", kind), "library_ms": None, "ms_fp32": fp32["ms"],
                "device_ms_fp32": fp32["device_ms"], "plain_ms_fp32": fp32["plain_ms"],
                "bound_ms_fp32": fp32["bound_ms"]}

    src = "uvhand_tpu_torch/ops/csrc/"
    k1, k23 = "uvhand_tpu/ops/msda_pallas.py:207", "uvhand_tpu/ops/msda_pallas.py:233, :320"
    k4, k5 = "uvhand_tpu/ops/msda_pallas.py:388", "uvhand_tpu/ops/msda_pallas.py:429"
    log(json.dumps({"kernels": [
        gather_row("msda_fwd", "staged", timed, max_err, cli_runs["fp32 train epoch"]["msda_fwd_staged"], k1),
        gather_row("msda_fwd", "general", timed, max_err, general["msda_fwd_general"], k1),
        gather_row("msda_bwd", "staged", btimed, bmax_err, cli_runs["fp32 train epoch"]["msda_bwd_staged"],
                   k23),
        gather_row("msda_bwd", "general", btimed, bmax_err, general["msda_bwd_general"], k23),
        fac_row("msda_fac_fwd", "staged", "fwd", cli_runs["bf16 FAC train epoch"]["msda_fac_fwd_staged"], k4),
        fac_row("msda_fac_fwd", "general", "fwd", fac_general["msda_fac_fwd_general"], k4),
        fac_row("msda_fac_bwd", "staged", "bwd", cli_runs["bf16 FAC train epoch"]["msda_fac_bwd_staged"], k5),
        fac_row("msda_fac_bwd", "general", "bwd", fac_general["msda_fac_bwd_general"], k5),
        *research_rows(research_numbers, by_path),
    ]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
