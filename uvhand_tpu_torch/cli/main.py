"""CLI driver of the port: train and evaluate arctic_sf with the reference's
flag surface, on the card.

Port of `uvhand_tpu/cli/main.py` (the reference's `main.py` and its
argparse chain), the ARCTIC single-frame route:

  python -m uvhand_tpu_torch.cli.main --dataset_file arctic --method arctic_sf \
      --setup p1 --coco_path data --output_dir exps/run1 --two_stage \
      --with_box_refine ...

The model options of the JAX CLI all run: the single-stage model (the
default, without `--two_stage`), `--with_box_refine`, `--position_embedding
learned`, `--no_aux_loss`, `--enc_lite` / `--enc_lite_hi_every`, `--remat`,
`--bf16`, `--bf16_params` (bfloat16 parameters with stochastic rounding;
implies `--bf16`), `--sgd`, the DINO variant (`--modelname dino`, with
contrastive denoising and look-forward-twice; `--use_dn` for the denoising
queries alone; `--dn_number`, `--label_noise_scale`, `--box_noise_scale`)
and the Swin-L and ConvNeXt-XL backbones (`--backbone swin_L_384_22k`,
`--backbone convnext_xlarge_22k`). `--two_stage` without
`--with_box_refine` (but for dino), and dino or `--use_dn` without
`--two_stage`, are models the JAX package cannot build or train either:
they raise a ValueError.

`--dataset_file AssemblyHands|H2O|FPHA` runs the COCO-format route
(`run_coco`): `AssemblyDETR` on `CocoHandsDataset` from
`{coco_path}/{dataset_file}`, trained with a checkpoint and an eval each
epoch, or evaluated with `--eval` (`--resume` a checkpoint); `--debug`,
`--num_debug` and `--cache_mode` apply. As in the JAX CLI, the model
takes only `--hidden_dim`, `--enc_layers`, `--dec_layers` and
`--num_feature_levels`, and the optimizer only `--lr`, `--weight_decay`
and `--clip_max_norm`.

The temporal routes run too. `--method arctic_lstm --window_size T`
trains on a window of T frames centred on each frame (`TempoTrainDataset`,
`--batch_size // T` windows a step), on every frame's targets with
`--split_window`, else on the centre frames' only; `--temporal_head lstm|
vivit` adds the in-model head that refines each window's selected
parameters (it needs `--method arctic_lstm` and T > 1, else the CLI exits
with the JAX CLI's message). `--train_smoothnet` trains an
`ArcticSmoother(T)` on whole windows behind the frozen base model
(`--resume` loads the base; `--smooth_resume` resumes the smoother apart
from it), one process, a checkpoint of the smoother each epoch:

  python -m uvhand_tpu_torch.cli.main --method arctic_lstm --window_size 32 \
      --temporal_head lstm --batch_size 32 --two_stage --with_box_refine ...
  python -m uvhand_tpu_torch.cli.main --train_smoothnet --window_size 32 \
      --resume exps/run1/9 --two_stage --with_box_refine ...

It reads ARCTIC from `{coco_path}/{dataset_file}` (`data/arctic.py`),
batches it (`data/loader.py`), trains with a checkpoint each epoch
(`train/checkpoint.py`), resumes (`--resume` a checkpoint directory or a
reference `.pth`, `--resume_dir` a sweep) and evaluates with the default
metric set, the sequence metrics MDev and ACC included. Every flag of the
JAX CLI is taken with its default; `--device` means the card unless it is
`cpu`. An option this port does not run would exit with a message naming
its ROADMAP item (`UNPORTED`, empty: the port runs every option of the
JAX CLI); none is ignored silently.
`--feature_type global_fm|local_fm` exits too: the JAX CLI fails on it
(ROADMAP Queue 3), and the feature path runs through the Python API.

The export routes, in the JAX CLI's order, after `--resume`:

  python -m uvhand_tpu_torch.cli.main --extraction_mode submit_pose \
      --resume exps/run1/9 --two_stage --with_box_refine ...  # ARCTIC submission
  python -m uvhand_tpu_torch.cli.main --extract ...    # backbone maps, {coco_path}/pickle
  python -m uvhand_tpu_torch.cli.main --eval --visualization --resume ...  # {output_dir}/vis

`--native_loader on|fast` decodes the images through the native library
(`uvhand_tpu_torch/native/`, built at first use into `build/native/`); it
raises where the library cannot be built. Every run prints how many images
took each route. `--stem_s2d` is the JAX package's TPU rewrite of the same
stem: taken, and the one stem runs.

Several processes, one device each, train and evaluate data-parallel:

  torchrun --nproc_per_node 8 -m uvhand_tpu_torch.cli.main ...   # one node
  srun --ntasks-per-node 8 python -m uvhand_tpu_torch.cli.main ...  # SLURM

With RANK or SLURM_PROCID in the environment the CLI joins the process
group first (`train/launch.py::init_multihost`: NCCL on the card, gloo
under `--device cpu`). `--batch_size` and `--val_batch_size` are global
sizes, split over the processes; each step's loss is the global batch's,
as in the JAX package (`engine.make_fused_train_step`); only rank 0 prints
and writes checkpoints and results. `--world_size`, `--rank`, `--dist_url`
and `--dist_backend` are taken and ignored, as the JAX CLI does.

`--mp N` puts the processes on a (dp, mp) mesh, dp = processes // mp
(`train/mesh.py::make_mesh`; it exits where they do not divide), and the
arctic route's train state is sharded by the JAX package's rule
(`shard_state`): the batch splits over dp, the large non-backbone 2-D
weights and their optimizer state over mp. As in the JAX CLI, only that
route's state is sharded, and `run_coco` ignores `--mp`; the export routes
and `--eval --visualization`, which run on rank 0 alone, read the whole
weights. On the CPU, 4 processes at mp 2:

  torchrun --nproc_per_node 4 -m uvhand_tpu_torch.cli.main --device cpu --mp 2 ...
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

import numpy as np
import torch


def get_args_parser():
    p = argparse.ArgumentParser("uvhand_tpu_torch", add_help=False)
    # general (settings.py:17-67)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--val_batch_size", default=4, type=int)
    p.add_argument("--eval_metrics", nargs="+",
                   default=["aae", "mpjpe.ra", "mrrpe", "success_rate",
                            "cdev", "mdev", "acc_err_pose"],
                   help="evaluation metrics to report (settings.py:29-30)")
    p.add_argument("--test_viewpoint", default=None, type=str,
                   help="evaluate one sid/seq/view only (settings.py:33-35)")
    p.add_argument("--seq", default=None, type=str,
                   help="single-sequence filter (settings.py:56)")
    p.add_argument("--iter", default=0, type=int,
                   help="eval-time frame-smoothing passes (settings.py:61)")
    p.add_argument("--full_validation", action="store_true")
    p.add_argument("--resume", default="", type=str)
    p.add_argument("--resume_dir", default="", type=str)
    p.add_argument("--not_use_params", default=[], nargs="+")
    p.add_argument("--output_dir", default="exps/default")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--num_debug", default=3, type=int)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--onecyclelr", action="store_true")
    p.add_argument("--use_augm", action="store_true")
    p.add_argument("--feature_type", default="origin",
                   choices=["origin", "global_fm", "local_fm"])
    p.add_argument("--train_smoothnet", action="store_true")
    p.add_argument("--smooth_resume", default="", type=str)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--extract", action="store_true",
                   help="dump backbone feature maps instead of training")
    p.add_argument("--extraction_mode", default="", type=str,
                   help="e.g. submit_pose: export predictions in ARCTIC layout")
    p.add_argument("--dn_number", default=100, type=int)
    p.add_argument("--label_noise_scale", default=0.5, type=float,
                   help="dn label flip probability scale (settings.py dn args)")
    p.add_argument("--box_noise_scale", default=1.0, type=float,
                   help="dn keypoint noise scale")
    p.add_argument("--use_dn", action="store_true",
                   help="enable denoising queries (same as --modelname dino)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 transformer compute (params stay fp32)")
    p.add_argument("--bf16_params", action="store_true",
                   help="store params in bf16 with stochastic-rounded "
                        "updates (drops the fp32 master-copy HBM traffic; "
                        "implies --bf16; changes numerics, opt-in)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize transformer layers in backprop "
                        "(lower HBM, ~15%% slower; needed for batch >= 24)")
    p.add_argument("--enc_lite", action="store_true",
                   help="Lite-DETR interleaved encoder: refine only low-res"
                        " tokens in most encoder layers (speed flag; changes"
                        " model semantics, weight-compatible checkpoints)")
    p.add_argument("--enc_lite_hi_every", type=int, default=3,
                   help="with --enc_lite: refine the full token set every"
                        " k-th encoder layer (and always in the last)")
    p.add_argument("--stem_s2d", default="on", choices=["on", "off"],
                   help="the JAX package's space-to-depth rewrite of the "
                        "ResNet stem conv for the TPU (the same function of "
                        "the same params); the port runs its one stem under "
                        "either value")
    p.add_argument("--visualization", action="store_true",
                   help="eval: dump 2D keypoint overlays instead of metrics"
                        " (settings.py:26, engine.py:740)")
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--workers_mode", default="thread",
                   choices=["thread", "process"],
                   help="host decode pool: threads (cv2 releases the GIL) "
                        "or fork-based processes (torch-DataLoader-workers "
                        "equivalent for python-bound datasets)")
    p.add_argument("--native_loader", default="off",
                   choices=["off", "on", "fast"],
                   help="C++ fused image pipeline (not ported: 'off' only): 'on' "
                        "= ROI-cropped full-res decode (OpenCV-identical), "
                        "'fast' = additionally scale the JPEG decode to the "
                        "crop window (geometry-exact, pixels approximate). "
                        "Falls back to the Python path if the toolchain is "
                        "missing.")
    p.add_argument("--not_use_optim_ckpt", action="store_true",
                   help="resume params only, fresh optimizer state")
    p.add_argument("--not_use_lr_scheduler_ckpt", action="store_true",
                   help="alias of --not_use_optim_ckpt here: the schedule"
                        " lives in the optimizer step count")
    p.add_argument("--save_checkpoint_interval", default=1, type=int)
    p.add_argument("--position_embedding", default="sine",
                   choices=["sine", "learned"])
    p.add_argument("--no_aux_loss", dest="aux_loss", action="store_false",
                   default=True)
    p.add_argument("--set_cost_class", default=1.5, type=float,
                   help="matcher class cost weight (settings.py:131)")
    p.add_argument("--set_cost_keypoint", default=4.0, type=float,
                   help="matcher keypoint L1 cost weight (settings.py:133)")
    p.add_argument("--config_file", "-c", default="", type=str,
                   help="SLConfig .py file merged into args"
                        " (settings.py:528-560 set_dino_args)")
    p.add_argument("--options", nargs="+", default=None,
                   help="key=value overrides applied to --config_file")
    p.add_argument("--cache_mode", action="store_true",
                   help="COCO datasets: cache decoded images in memory")
    p.add_argument("--make_pickle", action="store_true")
    # the card unless --device cpu; the rest accepted for command-line
    # compatibility (the process group comes from the environment,
    # train/launch.py; amp is the --bf16 knob here)
    p.add_argument("--device", default=None,
                   help="cuda (the default: the card; raises without one) or cpu")
    p.add_argument("--world_size", default=1, type=int)
    p.add_argument("--rank", default=0, type=int)
    p.add_argument("--dist_url", default="env://")
    p.add_argument("--dist_backend", default=None)
    p.add_argument("--amp", action="store_true")
    p.add_argument("--mp", default=1, type=int,
                   help="model-parallel axis size: large 2-D kernels shard "
                        "over this many devices (train/mesh.py param rule); "
                        "dp = n_devices // mp")
    # model (settings.py:71-155)
    p.add_argument("--modelname", default="deformable_detr",
                   choices=["deformable_detr", "dino"])
    p.add_argument("--lr", default=2e-4, type=float)
    p.add_argument("--lr_backbone", default=2e-5, type=float)
    p.add_argument("--lr_linear_proj_mult", default=0.1, type=float)
    p.add_argument("--batch_size", default=2, type=int)
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--epochs", default=50, type=int)
    p.add_argument("--lr_drop", default=40, type=int)
    p.add_argument("--clip_max_norm", default=0.1, type=float)
    p.add_argument("--sgd", action="store_true")
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--num_feature_levels", default=4, type=int)
    p.add_argument("--enc_layers", default=6, type=int)
    p.add_argument("--dec_layers", default=6, type=int)
    p.add_argument("--dim_feedforward", default=1024, type=int)
    p.add_argument("--hidden_dim", default=256, type=int)
    p.add_argument("--dropout", default=0.1, type=float)
    p.add_argument("--nheads", default=8, type=int)
    p.add_argument("--num_queries", default=300, type=int)
    p.add_argument("--dec_n_points", default=4, type=int)
    p.add_argument("--enc_n_points", default=4, type=int)
    p.add_argument("--two_stage", action="store_true", default=False)
    p.add_argument("--with_box_refine", action="store_true", default=False)
    p.add_argument("--cls_loss_coef", default=2.0, type=float)
    p.add_argument("--keypoint_loss_coef", default=5.0, type=float)
    p.add_argument("--focal_alpha", default=0.25, type=float)
    # arctic (parser.py:9-93; hardcoded focal 1000, img_res 224 :58-74)
    p.add_argument("--dataset_file", default="arctic")
    p.add_argument("--coco_path", default="data", type=str)
    p.add_argument("--method", default="arctic_sf",
                   choices=["arctic_sf", "arctic_lstm"])
    p.add_argument("--setup", default="p1")
    p.add_argument("--window_size", default=1, type=int)
    p.add_argument("--split_window", action="store_true",
                   help="arctic_lstm: per-frame targets (default: center-frame only)")
    p.add_argument("--temporal_head", default="none",
                   choices=["none", "lstm", "vivit"],
                   help="arctic_lstm: in-model temporal head refining the "
                        "selected params over each window (lstm = the "
                        "arctic_lstm BiLSTM design, vivit = TemporalAttention"
                        "; models/temporal/sequence.py). SmoothNet remains "
                        "the separate post-hoc stage (--train_smoothnet).")
    p.add_argument("--trainsplit", default="train",
                   choices=["train", "smalltrain", "tinytrain", "minitrain"])
    p.add_argument("--valsplit", default="val",
                   choices=["val", "smallval", "tinyval", "minival",
                            "test", "smalltest", "tinytest", "minitest"])
    p.add_argument("-f", "--fast_dev_run", action="store_true",
                   help="mini splits, batch 8, window 3 (parser.py:82-88)")
    p.add_argument("--img_res", default=224, type=int)
    p.add_argument("--focal_length", default=1000.0, type=float)
    p.add_argument("--speedup", action="store_true", default=True)
    p.add_argument("--ego_image_scale", default=0.3, type=float)
    p.add_argument("--mano_dir", default="data/body_models/mano", type=str)
    p.add_argument("--arctic_meta_dir", default="", type=str)
    return p


UNPORTED = (
    # (is the option given?, what it is, its ROADMAP Queue 1 item); none left
)
#: the datasets of the COCO-format route (`run_coco`)
COCO_DATASETS = ("AssemblyHands", "H2O", "FPHA")


def check_ported(args) -> None:
    """Exit with a message for each option of `args` that the port does not
    run (ROADMAP Queue 1)."""
    given = [(what, item) for on, what, item in UNPORTED if on(args)]
    if given:
        raise SystemExit("uvhand_tpu_torch: not ported yet: " + "; ".join(
            f"{what} (ROADMAP Queue 1 {item})" for what, item in given))


def check_feature_type(args) -> None:
    """Exit on `--feature_type global_fm|local_fm`, which the JAX CLI cannot
    run either (ROADMAP Queue 3)."""
    if args.feature_type != "origin":
        raise SystemExit(
            f"uvhand_tpu_torch: --feature_type {args.feature_type} is not run by the CLI: the "
            f"JAX CLI builds the model without a backbone and feeds it the loader's images, "
            f"and fails in parameter init (uvhand_tpu/cli/main.py, models/transformer.py: "
            f"TypeError, incompatible shapes); nothing in the data path produces feature maps. "
            f"Store them with --extract and feed UVHandDETR(feature_type=...) the maps of "
            f"cli/extract_features.py::load_feature_maps (ROADMAP Queue 3)")


def onecycle_epochs(args) -> int:
    """The epochs `--onecyclelr` schedules over: 32 for deformable_detr, 12
    for dino (the reference's settings)."""
    return 32 if args.modelname == "deformable_detr" else 12


def build_world(args, device):
    """MANO models + object bank on `device`: real assets if present,
    synthetic otherwise."""
    import os.path as op

    from ..geometry import mano as mano_lib
    from ..geometry import objects as obj_lib

    mano_r_p = op.join(args.mano_dir, "MANO_RIGHT.pkl")
    if op.exists(mano_r_p):
        mano_r = mano_lib.load_mano_pkl(mano_r_p, True, device=device)
        mano_l = mano_lib.load_mano_pkl(op.join(args.mano_dir, "MANO_LEFT.pkl"), False,
                                        device=device)
    else:
        print("WARNING: MANO assets not found; using synthetic test fixtures")
        mano_r = mano_lib.synthetic_mano(0, True, device=device)
        mano_l = mano_lib.synthetic_mano(1, False, device=device)

    meta = args.arctic_meta_dir or op.join(args.coco_path, args.dataset_file, "meta")
    if op.exists(op.join(meta, "object_meta.json")):
        bank = obj_lib.load_object_bank(meta, device=device)
    else:
        print("WARNING: ARCTIC object meshes not found; using synthetic bank")
        bank = obj_lib.synthetic_object_bank(2, device=device)
    return mano_r, mano_l, bank


def build_model(args, device):
    """The model of `args` on `device`, its weights drawn from a
    torch.Generator seeded with `--seed`: for the COCO-format datasets the
    `AssemblyDETR` (12 classes, of the flags only `--hidden_dim`,
    `--enc_layers`, `--dec_layers` and `--num_feature_levels`, as the JAX
    CLI builds it), else arctic_sf's `UVHandDETR`. `--bf16_params` implies
    the bf16 compute mode, and `--modelname dino` the denoising queries,
    with look-forward-twice wherever they are on, as in the JAX CLI."""
    from ..models.detr import UVHandDETR

    if args.dataset_file in COCO_DATASETS:
        from ..models.assembly import AssemblyDETR

        return AssemblyDETR(num_classes=12, d_model=args.hidden_dim,
                            num_encoder_layers=args.enc_layers,
                            num_decoder_layers=args.dec_layers,
                            num_feature_levels=args.num_feature_levels,
                            generator=torch.Generator().manual_seed(args.seed), device=device)
    use_dn = args.modelname == "dino" or args.use_dn
    return UVHandDETR(
        use_dn=use_dn, dino_variant=args.modelname == "dino", dn_number=args.dn_number,
        dn_label_noise_ratio=args.label_noise_scale, dn_box_noise_scale=args.box_noise_scale,
        look_forward_twice=use_dn, backbone=args.backbone,
        num_queries=args.num_queries, d_model=args.hidden_dim, n_heads=args.nheads,
        num_encoder_layers=args.enc_layers, num_decoder_layers=args.dec_layers,
        dim_feedforward=args.dim_feedforward, num_feature_levels=args.num_feature_levels,
        dec_n_points=args.dec_n_points, enc_n_points=args.enc_n_points,
        dropout=args.dropout, two_stage=args.two_stage, with_box_refine=args.with_box_refine,
        aux_loss=args.aux_loss, position_embedding=args.position_embedding,
        enc_lite=args.enc_lite, enc_lite_hi_every=args.enc_lite_hi_every, remat=args.remat,
        compute_dtype=torch.bfloat16 if (args.bf16 or args.bf16_params) else torch.float32,
        param_dtype=torch.bfloat16 if args.bf16_params else torch.float32,
        temporal_head=args.temporal_head,
        temporal_window=args.window_size if args.temporal_head != "none" else 0,
        generator=torch.Generator().manual_seed(args.seed), device=device)


def check_temporal(args) -> None:
    """Exit, as the JAX CLI does, where `--temporal_head` is given without
    the windows it mixes over."""
    if args.temporal_head != "none" and (args.method != "arctic_lstm" or args.window_size <= 1):
        raise SystemExit("--temporal_head requires --method arctic_lstm and "
                         "--window_size > 1 (the head mixes over window frames)")


def train_smoothnet(args, model, world, ds_train, device, max_steps=None) -> list:
    """`--train_smoothnet`: the base `model` frozen (resumed from `--resume`
    where given), an `ArcticSmoother(--window_size)` trained on whole
    windows of `ds_train` (`WindowDataset`, `collate_windows`, batches of
    `max(batch_size // window_size, 1)` windows) by AdamW at `--lr`, resumed
    from `--smooth_resume` apart from the base model, its checkpoint (the
    smoother and its optimizer) written each epoch to `{output_dir}/{epoch}`.
    Returns [{"epoch", "steps", "losses"}] (the epoch's last step's losses)."""
    from .. import engine
    from ..data import arctic as arctic_data
    from ..data.loader import DataLoader
    from ..train import checkpoint as ckpt
    from ..train import mesh
    from ..train import smoothnet_driver as sd

    if mesh.active():
        raise SystemExit("uvhand_tpu_torch: --train_smoothnet runs in one process (as the "
                         "JAX CLI's, which shards no smoother batch)")
    dlw = DataLoader(arctic_data.WindowDataset(ds_train, args.window_size),
                     max(args.batch_size // args.window_size, 1), seed=args.seed,
                     num_workers=args.num_workers, workers_mode=args.workers_mode,
                     collate_fn=arctic_data.collate_windows)
    smoother, optimizer = sd.create_smoother_state(
        args.window_size, lr=args.lr, generator=torch.Generator().manual_seed(args.seed),
        device=device)
    if args.smooth_resume:
        ckpt.load_checkpoint(args.smooth_resume, smoother, optimizer)
        print(f"smoother resumed from {args.smooth_resume}")
    step = sd.make_smoothnet_train_step(
        model, smoother, optimizer, *world, img_res=float(args.img_res),
        generator=torch.Generator(device=device).manual_seed(args.seed), device=device)
    epochs, steps = [], 0
    try:
        for epoch in range(args.epochs):
            dlw.set_epoch(epoch)
            for i, batch in enumerate(engine.device_prefetch(dlw, device)):
                losses = step(batch)
                steps += 1
                if max_steps and i + 1 >= max_steps:
                    break
            ckpt.save_checkpoint(args.output_dir, epoch, smoother, optimizer, step=steps,
                                 extra={"epoch": epoch})
            losses = {k: float(v) for k, v in losses.items()}
            print(f"smoothnet epoch {epoch}: loss={losses['total']:.4f}")
            epochs.append({"epoch": epoch, "steps": steps, "losses": losses})
    finally:
        dlw.close()
    return epochs


def main(args) -> dict:
    """Train or evaluate as `args` say; returns what the run produced:
    {"epochs": [{"epoch", "stats", "scores"}...]} after training,
    {"scores": [...]} (one per checkpoint) after --eval, {"smoothnet":
    [...]} after --train_smoothnet (`train_smoothnet`), and "timing" (the
    train steps' `wait_ms` and `step_ms`, the eval batches' `batch_ms`)."""
    from .. import engine
    from ..data import arctic as arctic_data
    from ..device import resolve_device
    from ..data.loader import DataLoader
    from ..train import checkpoint as ckpt
    from ..train import mesh
    from ..train.state import (create_optimizer, onecycle_schedule, scheduled,
                               set_schedule_step, step_schedule)
    from ..utils.logging import WandbLogger, save_results

    if "RANK" in os.environ or "SLURM_PROCID" in os.environ:
        # a torchrun or SLURM launch (util/misc.py:519 surface)
        from ..train.launch import init_multihost, print_on_main_only

        topo = init_multihost(device=args.device)
        print_on_main_only()
        print(f"multihost: {topo} backend={torch.distributed.get_backend()}")
    rank, world_size = mesh.rank_and_world()
    os.makedirs(args.output_dir, exist_ok=True)
    if args.config_file:
        # SLConfig merge: cfg keys NOT already on args are added; --options
        # overrides cfg. So a flag keeps its value (or default) over the
        # file's: `-c configs/DINO/DINO_4scale.py` neither sets `use_dn`
        # nor `modelname`, as in the JAX CLI
        from ..utils.slconfig import SLConfig

        cfg = SLConfig.fromfile(args.config_file)
        if args.options:
            cfg.merge_from_list(list(args.options))
        for k, v in cfg.items():
            if k not in vars(args):
                setattr(args, k, v)
        if rank == 0:
            with open(os.path.join(args.output_dir, "config_args_raw.json"), "w") as f:
                json.dump(vars(args), f, indent=2, default=str)
    check_ported(args)
    check_feature_type(args)
    if args.dataset_file not in COCO_DATASETS:  # run_coco ignores --mp, as the JAX CLI's
        why = mesh.check_axes(world_size, args.mp)
        if why:
            raise SystemExit(f"uvhand_tpu_torch: {why}")
    device = resolve_device(args.device)
    if mesh.active() and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())  # this process's card
    if device.type == "cuda":
        # float32 stays float32 (the parity mode): no TF32 in GEMMs or convs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if rank == 0:
        with open(os.path.join(args.output_dir, "running_cmd.json"), "w") as f:
            json.dump(vars(args), f, indent=2, default=str)

    if getattr(args, "fast_dev_run", False):
        args.batch_size = 8
        args.trainsplit = "minitrain"
        args.valsplit = "minival"
        args.window_size = 3
    check_temporal(args)

    np.random.seed(args.seed)
    if args.dataset_file in COCO_DATASETS:
        return run_coco(args, device)
    mano_r, mano_l, bank = build_world(args, device)
    world = (mano_r, mano_l, bank)
    model = build_model(args, device)
    mesh.broadcast_params(model)  # seeded alike everywhere; rank 0's are the run's
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model params: {n_params / 1e6:.1f}M")
    grid = mesh.make_mesh(args.mp, device.type)

    root = os.path.join(args.coco_path, args.dataset_file)
    kp3d_cano = bank.kp_bottom.cpu().numpy()
    ds_train = arctic_data.ArcticDataset(
        root, args.setup, args.trainsplit, img_res=args.img_res,
        focal_length=args.focal_length, kp3d_cano=kp3d_cano,
        two_stage=args.two_stage, aug=args.use_augm or None, native_images=args.native_loader)
    ds_val = arctic_data.ArcticDataset(
        root, args.setup, args.valsplit, img_res=args.img_res,
        focal_length=args.focal_length, kp3d_cano=kp3d_cano,
        two_stage=args.two_stage, seq=args.seq, viewpoint=args.test_viewpoint,
        native_images=args.native_loader)
    # this process's rows of each batch: the mp processes of a dp row take the same
    shard = dict(rank=grid.dp_rank, world_size=grid.dp)
    if args.method == "arctic_lstm" and not args.eval and not args.train_smoothnet:
        # a window of --window_size frames centred on each frame (TempoDataset),
        # batch_size // window_size windows a step flattened to frames; each
        # process takes whole windows; targets per frame (--split_window) or
        # the centre frames' only
        dl_train = DataLoader(
            arctic_data.TempoTrainDataset(ds_train, args.window_size,
                                          split_window=args.split_window),
            max(args.batch_size // args.window_size, 1), seed=args.seed,
            num_workers=args.num_workers, workers_mode=args.workers_mode,
            collate_fn=functools.partial(arctic_data.collate_tempo_train,
                                         split_window=args.split_window), **shard)
    else:
        dl_train = DataLoader(ds_train, args.batch_size, seed=args.seed,
                              num_workers=args.num_workers, workers_mode=args.workers_mode,
                              **shard)
    dl_val = DataLoader(ds_val, args.val_batch_size, shuffle=False, drop_last=False,
                        num_workers=args.num_workers, workers_mode=args.workers_mode, **shard)

    optimizer = create_optimizer(model, lr=args.lr, lr_backbone=args.lr_backbone,
                                 lr_linear_proj_mult=args.lr_linear_proj_mult,
                                 weight_decay=args.weight_decay, sgd=args.sgd,
                                 sr_seed=args.seed)
    steps_per_epoch = max(len(dl_train), 1)
    if args.onecyclelr:
        sched = onecycle_schedule(args.lr, steps_per_epoch * onecycle_epochs(args))
    else:
        sched = step_schedule(args.lr, args.lr_drop * steps_per_epoch)
    scheduler = scheduled(optimizer, sched, args.lr)

    def restore(path):
        """Resume from `path`: a reference `.pth` (parameters only) or a
        checkpoint directory (parameters, optimizer and step)."""
        if path.endswith(".pth"):
            ckpt.load_torch_pth(path, model, args.not_use_params)
            return
        info = ckpt.load_checkpoint(
            path, model, optimizer, args.not_use_params,
            load_opt=not (args.not_use_optim_ckpt or args.not_use_lr_scheduler_ckpt))
        set_schedule_step(scheduler, info["step"])  # the schedule continues there

    if args.resume:
        restore(args.resume)
        print(f"resumed from {args.resume}")
    whole_only = args.extract or args.extraction_mode or args.train_smoothnet or (
        args.eval and args.visualization)  # one process's routes read the whole weights
    if grid.mp > 1 and not whole_only:
        # replicate over dp, shard the large kernels and their state over mp
        shards = mesh.shard_state(grid, model, optimizer)
        print(f"--mp {grid.mp}: dp {grid.dp} x mp {grid.mp}, {len(shards)} parameters "
              f"sharded over mp")

    fused = engine.make_fused_train_step(
        model, *world, optimizer, img_res=float(args.img_res),
        cost_class=args.set_cost_class, cost_keypoint=args.set_cost_keypoint,
        clip_max_norm=args.clip_max_norm,
        generator=torch.Generator(device=device).manual_seed(
            mesh.process_seed(args.seed, grid.dp_rank)),
        device=device, process_group=grid.dp_group, model_group=grid.mp_group)

    def train_step(batch):
        loss_dict = fused(batch)
        scheduler.step()
        return loss_dict

    train_step.device = fused.device
    eval_step = engine.make_eval_step(model, *world, float(args.img_res),
                                      metrics=tuple(args.eval_metrics),
                                      smooth_iter=args.iter, device=device)
    max_steps = args.num_debug if args.debug else None
    # the sequence metrics (mdev, acc_err_pose) come from the sequence pass,
    # which runs whenever one of them is asked for
    needs_seq_eval = bool({"mdev", "acc_err_pose"} & set(args.eval_metrics))
    timing: dict = {}
    result: dict = {"timing": timing}

    try:
        if args.extract or args.extraction_mode:
            result.update(export(args, model, ds_train, ds_val, timing, rank))
            return result
        if args.train_smoothnet:
            result["smoothnet"] = train_smoothnet(args, model, world, ds_train, device,
                                                   max_steps)
            return result
        if args.eval and args.visualization:
            # 2D keypoint overlays and OBJ meshes (the reference's
            # visualize_arctic_result), written by rank 0
            from ..evaluation.visualize import save_eval_visualizations

            if rank == 0:
                out = save_eval_visualizations(
                    model, ds_val, *world, os.path.join(args.output_dir, "vis"),
                    float(args.img_res),
                    max_frames=args.num_debug * args.val_batch_size if args.debug else 64)
                print(f"visualizations written to {out}")
                result["visualization"] = out
            mesh.barrier()
            return result
        if args.eval:
            ckpts = ckpt.list_checkpoints(args.resume_dir) if args.resume_dir else [None]
            result["scores"] = []
            for c in ckpts:
                if c is not None:
                    ckpt.load_checkpoint(c, model, None, args.not_use_params)
                scores = engine.evaluate(eval_step, dl_val, max_steps=max_steps, timing=timing,
                                         group=grid.dp_group)
                if args.full_validation or needs_seq_eval:
                    seq_step = engine.make_sequence_eval_step(model, *world, float(args.img_res),
                                                              device=device)
                    scores.update(engine.evaluate_sequences(
                        seq_step, ds_val, args.val_batch_size,
                        max_frames=args.num_debug * args.val_batch_size if args.debug
                        else None))
                print(json.dumps(scores, indent=2))
                hdr = (f"{args.test_viewpoint} " if args.test_viewpoint else "") + \
                    f"{args.val_batch_size}*{args.window_size}, {args.iter}iter"
                save_results(args.output_dir, -1, score_dict=scores, header=hdr)
                result["scores"].append(scores)
            return result

        wb = WandbLogger(args.wandb, config=vars(args))
        result["epochs"] = []
        for epoch in range(args.start_epoch, args.epochs):
            t0 = time.time()
            stats = engine.train_one_epoch(train_step, dl_train, epoch, max_steps=max_steps,
                                           timing=timing)
            if (epoch + 1) % args.save_checkpoint_interval == 0:
                ckpt.save_checkpoint(args.output_dir, epoch, model, optimizer,
                                     step=scheduler.last_epoch, extra={"epoch": epoch})
            scores = engine.evaluate(eval_step, dl_val, max_steps=max_steps, timing=timing,
                                     group=grid.dp_group)
            save_results(args.output_dir, epoch, loss_dict=stats, score_dict=scores)
            wb.log({**stats, **scores}, step=epoch)
            print(f"epoch {epoch}: {time.time() - t0:.1f}s train_loss={stats.get('loss'):.4f} "
                  + json.dumps(scores))
            result["epochs"].append({"epoch": epoch, "stats": stats, "scores": scores})
        wb.finish()
        return result
    finally:
        dl_train.close()
        dl_val.close()
        result["image_routes"] = {"train": dict(ds_train.image_routes),
                                  "val": dict(ds_val.image_routes)}
        print(f"images decoded (native_loader {args.native_loader}): "
              f"{json.dumps(result['image_routes'])}")


def export(args, model, ds_train, ds_val, timing, rank) -> dict:
    """`--extract` (the backbone's maps of the train split, stored under
    `{coco_path}/pickle` in batches of `--batch_size`) or `--extraction_mode`
    (whatever its value: the ARCTIC submission of the val split, restricted
    to the protocol's sequences where its file exists, under
    `{output_dir}/submission` in batches of `--val_batch_size`), as the JAX
    CLI routes them; rank 0 writes, the other processes wait."""
    from ..train import mesh
    from .extract_features import extract_features
    from .extract_predicts import load_protocol_seqs, run_extraction

    out = {}
    if rank == 0:
        if args.extract:
            out["features"] = extract_features(
                model, ds_train, os.path.join(args.coco_path, "pickle"), args.setup,
                args.trainsplit, batch_size=args.batch_size)
            print(f"features dumped to {out['features']}")
        else:
            out["submission"] = run_extraction(
                model, ds_val, args.val_batch_size, os.path.join(args.output_dir, "submission"),
                float(args.img_res),
                seqs=load_protocol_seqs(args.coco_path, args.dataset_file, args.setup),
                timing=timing)
            print(f"submission written to {out['submission']}")
    mesh.barrier()
    return out


def run_coco(args, device) -> dict:
    """The AssemblyHands / H2O / FPHA route, as the JAX CLI's `run_coco`
    runs it (the reference's COCO-format build and `eval_coco`):
    `CocoHandsDataset` from `{coco_path}/{dataset_file}` (train split with
    the colour jitter and rotation, `--cache_mode`), `AssemblyDETR`, and
    either `--eval` (the scores of the val split, every batch, each GT
    slot predicted by the query most probable for its label) or training:
    each epoch its steps (`--debug`: `--num_debug` of them), a checkpoint
    and the eval. `--resume` restores a checkpoint directory (parameters,
    optimizer and step) or a reference `.pth` (parameters). The optimizer
    is AdamW at `--lr` and `--weight_decay` with the backbone at 2e-5 and
    the sampling offsets at 0.1 x lr, with no schedule, whatever
    `--lr_backbone`, `--lr_linear_proj_mult` or `--sgd` say (the JAX CLI
    takes `create_train_state`'s defaults there). Over several processes
    each takes its share of every batch, the step's loss is the global
    batch's, and rank 0 writes. Returns {"epochs": [{"epoch", "stats",
    "scores"}]} or {"scores": [scores]}, with "timing"."""
    from .. import engine
    from ..data.coco_hands import CocoHandsDataset, collate
    from ..data.loader import DataLoader
    from ..train import checkpoint as ckpt
    from ..train import mesh
    from ..train.state import create_optimizer
    from ..utils.logging import save_results

    rank, world_size = mesh.rank_and_world()
    model = build_model(args, device)
    mesh.broadcast_params(model)  # seeded alike everywhere; rank 0's are the run's
    print(f"model params: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M")
    root = os.path.join(args.coco_path, args.dataset_file)
    ds_train = CocoHandsDataset(root, args.trainsplit, img_res=args.img_res,
                                aug=not args.make_pickle, seed=args.seed,
                                cache_mode=args.cache_mode)
    ds_val = CocoHandsDataset(root, args.valsplit, img_res=args.img_res,
                              cache_mode=args.cache_mode)
    loader = dict(collate_fn=collate, num_workers=args.num_workers,
                  workers_mode=args.workers_mode, rank=rank, world_size=world_size)
    dl_train = DataLoader(ds_train, args.batch_size, seed=args.seed, **loader)
    dl_val = DataLoader(ds_val, args.val_batch_size, shuffle=False, drop_last=False, **loader)
    optimizer = create_optimizer(model, lr=args.lr, weight_decay=args.weight_decay)
    steps = 0
    if args.resume:
        if args.resume.endswith(".pth"):
            ckpt.load_torch_pth(args.resume, model, args.not_use_params)
        else:
            steps = ckpt.load_checkpoint(
                args.resume, model, optimizer, args.not_use_params,
                load_opt=not (args.not_use_optim_ckpt or args.not_use_lr_scheduler_ckpt))["step"]
        print(f"resumed from {args.resume}")
    train_step = engine.make_assembly_train_step(
        model, optimizer, clip_max_norm=args.clip_max_norm,
        generator=torch.Generator(device=device).manual_seed(mesh.process_seed(args.seed)),
        device=device, process_group=torch.distributed.group.WORLD if mesh.active() else None)
    eval_step = engine.make_assembly_eval_step(model, device=device)
    timing: dict = {}
    result: dict = {"timing": timing}
    try:
        if args.eval:
            scores = engine.evaluate_assembly(eval_step, dl_val, args.img_res, timing=timing)
            print(json.dumps(scores, indent=2))
            save_results(args.output_dir, -1, score_dict=scores)
            result["scores"] = [scores]
            return result
        result["epochs"] = []
        for epoch in range(args.start_epoch, args.epochs):
            t0 = time.time()
            stats = engine.train_one_epoch(train_step, dl_train, epoch,
                                           max_steps=args.num_debug if args.debug else None,
                                           timing=timing)
            steps += min(len(dl_train), args.num_debug) if args.debug else len(dl_train)
            ckpt.save_checkpoint(args.output_dir, epoch, model, optimizer, step=steps,
                                 extra={"epoch": epoch})
            scores = engine.evaluate_assembly(eval_step, dl_val, args.img_res, timing=timing)
            save_results(args.output_dir, epoch, loss_dict=stats, score_dict=scores)
            print(f"epoch {epoch}: {time.time() - t0:.1f}s train_loss={stats.get('loss'):.4f} "
                  + json.dumps(scores))
            result["epochs"].append({"epoch": epoch, "stats": stats, "scores": scores})
        return result
    finally:
        dl_train.close()
        dl_val.close()


def cli_entry(argv=None):
    parser = argparse.ArgumentParser("uvhand_tpu_torch driver", parents=[get_args_parser()])
    try:
        main(parser.parse_args(argv))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    cli_entry()
