"""CLI driver of the port: train and evaluate arctic_sf with the reference's
flag surface, on the card.

Port of `uvhand_tpu/cli/main.py` (the reference's `main.py` and its
argparse chain), the ARCTIC single-frame route:

  python -m uvhand_tpu_torch.cli.main --dataset_file arctic --method arctic_sf \
      --setup p1 --coco_path data --output_dir exps/run1 --two_stage \
      --with_box_refine ...

It reads ARCTIC from `{coco_path}/{dataset_file}` (`data/arctic.py`),
batches it (`data/loader.py`), trains with a checkpoint each epoch
(`train/checkpoint.py`), resumes (`--resume` a checkpoint directory or a
reference `.pth`, `--resume_dir` a sweep) and evaluates with the default
metric set, the sequence metrics MDev and ACC included. Every flag of the
JAX CLI is taken with its default; `--device` means the card unless it is
`cpu`. An option this port does not run exits with a message naming its
ROADMAP item (`UNPORTED`); none is ignored silently. `--stem_s2d` is the
JAX package's TPU rewrite of the same stem: taken, and the one stem runs.
"""

from __future__ import annotations

import argparse
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
    # compatibility (one process on one card; amp is the --bf16 knob here)
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
    # (is the option given?, what it is, its ROADMAP Queue 1 item)
    (lambda a: a.remat, "--remat", "item 2 (main-path modes)"),
    (lambda a: a.enc_lite, "--enc_lite", "item 2 (main-path modes)"),
    (lambda a: a.bf16_params, "--bf16_params", "item 2 (main-path modes)"),
    (lambda a: a.sgd, "--sgd", "item 2 (main-path modes)"),
    (lambda a: a.use_dn or a.modelname == "dino", "--use_dn / --modelname dino",
     "item 8 (DINO)"),
    (lambda a: a.method == "arctic_lstm", "--method arctic_lstm", "item 9 (temporal)"),
    (lambda a: a.temporal_head != "none", "--temporal_head", "item 9 (temporal)"),
    (lambda a: a.train_smoothnet, "--train_smoothnet", "item 9 (temporal)"),
    (lambda a: a.extract, "--extract", "item 12 (cli/extract_features.py)"),
    (lambda a: bool(a.extraction_mode), "--extraction_mode",
     "item 12 (cli/extract_predicts.py)"),
    (lambda a: a.visualization, "--visualization", "item 12 (evaluation/visualize.py)"),
    (lambda a: a.native_loader != "off", "--native_loader on|fast",
     "item 4 (the native image path)"),
    (lambda a: a.position_embedding != "sine", "--position_embedding learned",
     "item 7 (model options)"),
    (lambda a: a.feature_type != "origin", "--feature_type global_fm|local_fm",
     "item 7 (model options)"),
    (lambda a: not (a.two_stage and a.with_box_refine),
     "a model without --two_stage --with_box_refine", "item 7 (model options)"),
    (lambda a: not a.aux_loss, "--no_aux_loss", "item 7 (model options)"),
    (lambda a: a.backbone != "resnet50", "--backbone other than resnet50",
     "items 8 and 10 (ConvNeXt, Swin-L)"),
    (lambda a: a.mp > 1, "--mp > 1", "item 6 (multi-GPU)"),
    (lambda a: a.world_size > 1 or int(os.environ.get("WORLD_SIZE", "1")) > 1,
     "a multi-process launch (--world_size or WORLD_SIZE > 1)", "item 6 (multi-GPU)"),
    (lambda a: a.dataset_file in ("AssemblyHands", "H2O", "FPHA"),
     "the AssemblyHands/H2O/FPHA datasets", "item 11 (AssemblyHands / COCO family)"),
)


def check_ported(args) -> None:
    """Exit with a message for each option of `args` that the port does not
    run (ROADMAP Queue 1)."""
    given = [(what, item) for on, what, item in UNPORTED if on(args)]
    if given:
        raise SystemExit("uvhand_tpu_torch: not ported yet: " + "; ".join(
            f"{what} (ROADMAP Queue 1 {item})" for what, item in given))


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
    """The arctic_sf model of `args` on `device`, its weights drawn from a
    torch.Generator seeded with `--seed`."""
    from ..models.detr import UVHandDETR

    return UVHandDETR(
        num_queries=args.num_queries, d_model=args.hidden_dim, n_heads=args.nheads,
        num_encoder_layers=args.enc_layers, num_decoder_layers=args.dec_layers,
        dim_feedforward=args.dim_feedforward, num_feature_levels=args.num_feature_levels,
        dec_n_points=args.dec_n_points, enc_n_points=args.enc_n_points,
        dropout=args.dropout,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        generator=torch.Generator().manual_seed(args.seed), device=device)


def main(args) -> dict:
    """Train or evaluate as `args` say; returns what the run produced:
    {"epochs": [{"epoch", "stats", "scores"}...]} after training,
    {"scores": [...]} (one per checkpoint) after --eval, and "timing" (the
    train steps' `wait_ms` and `step_ms`, the eval batches' `batch_ms`)."""
    from .. import engine
    from ..data import arctic as arctic_data
    from ..device import resolve_device
    from ..data.loader import DataLoader
    from ..train import checkpoint as ckpt
    from ..train.state import (create_optimizer, onecycle_schedule, scheduled,
                               set_schedule_step, step_schedule)
    from ..utils.logging import WandbLogger, save_results

    os.makedirs(args.output_dir, exist_ok=True)
    if args.config_file:
        # SLConfig merge: cfg keys NOT already on args are added; --options
        # overrides cfg
        from ..utils.slconfig import SLConfig

        cfg = SLConfig.fromfile(args.config_file)
        if args.options:
            cfg.merge_from_list(list(args.options))
        for k, v in cfg.items():
            if k not in vars(args):
                setattr(args, k, v)
        with open(os.path.join(args.output_dir, "config_args_raw.json"), "w") as f:
            json.dump(vars(args), f, indent=2, default=str)
    check_ported(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # float32 stays float32 (the parity mode): no TF32 in GEMMs or convs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(args.output_dir, "running_cmd.json"), "w") as f:
        json.dump(vars(args), f, indent=2, default=str)

    if getattr(args, "fast_dev_run", False):
        args.batch_size = 8
        args.trainsplit = "minitrain"
        args.valsplit = "minival"
        args.window_size = 3

    np.random.seed(args.seed)
    mano_r, mano_l, bank = build_world(args, device)
    world = (mano_r, mano_l, bank)
    model = build_model(args, device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model params: {n_params / 1e6:.1f}M")

    root = os.path.join(args.coco_path, args.dataset_file)
    kp3d_cano = bank.kp_bottom.cpu().numpy()
    ds_train = arctic_data.ArcticDataset(
        root, args.setup, args.trainsplit, img_res=args.img_res,
        focal_length=args.focal_length, kp3d_cano=kp3d_cano,
        two_stage=args.two_stage, aug=args.use_augm or None)
    ds_val = arctic_data.ArcticDataset(
        root, args.setup, args.valsplit, img_res=args.img_res,
        focal_length=args.focal_length, kp3d_cano=kp3d_cano,
        two_stage=args.two_stage, seq=args.seq, viewpoint=args.test_viewpoint)
    dl_train = DataLoader(ds_train, args.batch_size, seed=args.seed,
                          num_workers=args.num_workers, workers_mode=args.workers_mode)
    dl_val = DataLoader(ds_val, args.val_batch_size, shuffle=False, drop_last=False,
                        num_workers=args.num_workers, workers_mode=args.workers_mode)

    optimizer = create_optimizer(model, lr=args.lr, lr_backbone=args.lr_backbone,
                                 lr_linear_proj_mult=args.lr_linear_proj_mult,
                                 weight_decay=args.weight_decay)
    steps_per_epoch = max(len(dl_train), 1)
    if args.onecyclelr:
        sched = onecycle_schedule(args.lr, steps_per_epoch * 32)  # deformable_detr's 32
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

    fused = engine.make_fused_train_step(
        model, *world, optimizer, img_res=float(args.img_res),
        cost_class=args.set_cost_class, cost_keypoint=args.set_cost_keypoint,
        clip_max_norm=args.clip_max_norm,
        generator=torch.Generator(device=device).manual_seed(args.seed), device=device)

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
        if args.eval:
            ckpts = ckpt.list_checkpoints(args.resume_dir) if args.resume_dir else [None]
            result["scores"] = []
            for c in ckpts:
                if c is not None:
                    ckpt.load_checkpoint(c, model, None, args.not_use_params)
                scores = engine.evaluate(eval_step, dl_val, max_steps=max_steps, timing=timing)
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
            scores = engine.evaluate(eval_step, dl_val, max_steps=max_steps, timing=timing)
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


def cli_entry(argv=None):
    parser = argparse.ArgumentParser("uvhand_tpu_torch driver", parents=[get_args_parser()])
    main(parser.parse_args(argv))


if __name__ == "__main__":
    cli_entry()
