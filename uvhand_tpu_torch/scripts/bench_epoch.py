"""Epoch throughput with the host's input pipeline: port of `scripts/bench_epoch.py`.

    python -m uvhand_tpu_torch.scripts.bench_epoch [--frames 512] [--batch 16]
        [--fp32] [--workers 16] [--workers_mode thread|process]
        [--native off|on|fast] [--host_only] [--scan_workers 1,2,4]
        [--device cpu] [--hidden_dim 64 ...]

The bench (`uvhand_tpu_torch.bench`) times the card on one resident batch.
This times what a user's epoch sees: a synthetic ARCTIC root on disk of
840x600 JPEGs (2 views, 64 frames a sequence, max(1, frames // 128)
sequences), read by `ArcticDataset` (decode, crop and augmentation, GT
assembly) in `DataLoader` workers, copied to the card ahead of the step by
`device_prefetch`, and the fused train step (`engine.make_fused_train_step`)
of arctic_sf at full width (the flags shrink it), bf16 compute unless
`--fp32`. Two warm-up steps, then an epoch of min(frames, len) // batch
steps on the host clock (`engine.train_one_epoch`, which reads each
step's loss). It prints one JSON line, the TPU script's keys:
{"metric": "epoch_frames_per_sec", "value", "unit", "steps", "batch", "note"}.

`--host_only` times the loader alone (decode, augmentation, GT assembly,
collate; the first batch a warm-up) and prints
{"metric": "host_pipeline_frames_per_sec", "value", "unit", "workers",
"mode"}; it never touches CUDA. `--scan_workers 1,2,4` prints
{"mode", "workers", "host_frames_per_sec"} for each count in thread and in
process mode. `--native on|fast` decodes through the native library
(`uvhand_tpu_torch/native/`), which raises with the compiler's message
where it cannot be built (the card host lacks the OpenCV and libjpeg
headers); it never falls back. Values are not rounded.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

VIEWS, FRAMES_A_SEQUENCE = 2, 64


def dataset(root: str, frames: int, native: str, img_res: int):
    """The synthetic root (840x600 JPEGs) and its train split's dataset."""
    from uvhand_tpu_torch.data import arctic
    from uvhand_tpu_torch.geometry import objects

    bank = objects.synthetic_object_bank(2, device="cpu")
    arctic.make_synthetic_root(root, num_seqs=max(1, frames // (VIEWS * FRAMES_A_SEQUENCE)),
                               frames=FRAMES_A_SEQUENCE, views=VIEWS, obj_bank=bank)
    return arctic.ArcticDataset(root, "p1", "train", img_res=img_res,
                                kp3d_cano=bank.kp_bottom.numpy(), native_images=native)


def host_fps(ds, batch: int, n_frames: int, workers: int, mode: str) -> float:
    """Frames/s of the loader alone over n_frames // batch batches, the
    first one a warm-up (the page cache, the pool's start)."""
    from uvhand_tpu_torch.data.loader import DataLoader

    dl = DataLoader(ds, batch, seed=0, num_workers=workers, workers_mode=mode)
    try:
        n_steps = max(n_frames // batch, 2)
        it = iter(dl)
        next(it)
        t0 = time.perf_counter()
        done = 1
        for _ in it:
            done += 1
            if done >= n_steps:
                break
        return (done - 1) * batch / (time.perf_counter() - t0)
    finally:
        dl.close()


def epoch_fps(args, ds, n_frames: int) -> dict:
    from uvhand_tpu_torch import engine
    from uvhand_tpu_torch.data.loader import DataLoader
    from uvhand_tpu_torch.device import resolve_device
    from uvhand_tpu_torch.geometry import mano, objects
    from uvhand_tpu_torch.models.detr import UVHandDETR
    from uvhand_tpu_torch.train.state import create_optimizer

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    world = (mano.synthetic_mano(0, True, device=device),
             mano.synthetic_mano(1, False, device=device),
             objects.synthetic_object_bank(2, device=device))
    model = UVHandDETR(num_queries=args.num_queries, d_model=args.hidden_dim,
                       n_heads=args.nheads, num_encoder_layers=args.enc_layers,
                       num_decoder_layers=args.dec_layers, dim_feedforward=args.dim_feedforward,
                       compute_dtype=torch.float32 if args.fp32 else torch.bfloat16,
                       generator=torch.Generator().manual_seed(0), device=device)
    step = engine.make_fused_train_step(
        model, *world, create_optimizer(model), img_res=float(args.img_res),
        generator=torch.Generator(device=device).manual_seed(0), device=device)
    dl = DataLoader(ds, args.batch, seed=0, num_workers=args.workers,
                    workers_mode=args.workers_mode)
    try:
        n_steps = n_frames // args.batch
        engine.train_one_epoch(step, dl, 0, max_steps=2, print_freq=100)  # warm-up
        t0 = time.perf_counter()
        engine.train_one_epoch(step, dl, 1, max_steps=n_steps, print_freq=1000)
        dt = time.perf_counter() - t0
    finally:
        dl.close()
    return {"metric": "epoch_frames_per_sec", "value": n_steps * args.batch / dt,
            "unit": "frames/s", "steps": n_steps, "batch": args.batch,
            "note": "disk jpeg decode + aug + GT assembly + H2D + fused step"}


def get_args_parser():
    from uvhand_tpu_torch.bench import get_args_parser as widths

    ap = argparse.ArgumentParser("uvhand_tpu_torch.scripts.bench_epoch", parents=[widths()],
                                 add_help=False, description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--workers", type=int, default=16)
    ap.add_argument("--workers_mode", default="thread", choices=["thread", "process"])
    ap.add_argument("--host_only", action="store_true",
                    help="the host pipeline alone (no step); never touches CUDA")
    ap.add_argument("--scan_workers", default="",
                    help="comma list, e.g. 1,2,4: host frames/s over worker counts x both modes")
    ap.add_argument("--native", default="off", choices=["off", "on", "fast"],
                    help="the native image library (uvhand_tpu_torch/native)")
    return ap


def main(argv=None) -> list:
    args = get_args_parser().parse_args(argv)
    rows = []
    with tempfile.TemporaryDirectory(prefix="arctic_bench_") as tmp:
        ds = dataset(os.path.join(tmp, "arctic"), args.frames, args.native, args.img_res)
        n_frames = min(len(ds), args.frames)
        if args.scan_workers:
            for mode in ("thread", "process"):
                for w in [int(x) for x in args.scan_workers.split(",")]:
                    rows.append({"mode": mode, "workers": w,
                                 "host_frames_per_sec": host_fps(ds, args.batch, n_frames, w,
                                                                 mode)})
                    print(json.dumps(rows[-1]), flush=True)
        elif args.host_only:
            rows.append({"metric": "host_pipeline_frames_per_sec",
                         "value": host_fps(ds, args.batch, n_frames, args.workers,
                                           args.workers_mode),
                         "unit": "frames/s", "workers": args.workers, "mode": args.workers_mode})
            print(json.dumps(rows[-1]), flush=True)
        else:
            rows.append(epoch_fps(args, ds, n_frames))
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
