"""A/B study of the dense encoder against enc_lite: port of `scripts/ab_enc_lite.py`.

    python -m uvhand_tpu_torch.scripts.ab_enc_lite [--chunks 20] [--batch 16]
        [--scan 60] [--eval_metrics] [--train_batches 4] [--variants dense,lite3]
        [--out DIR] [--device cpu] [--hidden_dim 64 ...]

`enc_lite` (Lite-DETR's interleaved encoder: the encoder's low-resolution
layers refine only the low-resolution tokens) changes what the model
computes, so it needs evidence beside its speed. Each variant ("dense", or
"liteK": enc_lite refreshing the whole token set every K-th layer) starts
from the same seed (weights, dropout) and takes `--chunks` x `--scan` fused
train steps (`engine.make_fused_train_step`, bf16 compute, AdamW lr 2e-4)
on the same data: one batch of a synthetic ARCTIC root, or with
`--eval_metrics` `--train_batches` batches of a root whose images have
their projected GT drawn in (`render_gt=True`), cycled within each chunk.
It prints each chunk's mean of the tracked loss terms and, with
`--eval_metrics`, the held-out metrics of each variant on two batches of
another rendered root (seed 1) through `engine.make_eval_step`. The last
line is the summary, with the TPU script's keys (`ab_enc_lite.py:194`):
"metric", "variants", "last60_ratio_<variant>_over_<first>" (the last
chunk's means over the first variant's), each variant's {"chunk_means",
"last60_mean", "steps", "wall_s"[, "heldout_metrics"]}, and "heldout".
`--out DIR` also writes each variant's per-step curves (`ab_enc_lite_<name>.npz`).

The TPU script chains each chunk's steps in one `lax.scan` so that its
persistent compile cache hits (a remote compile cost 10-20 minutes a
program); the port compiles nothing (eager PyTorch and prebuilt kernels),
so a chunk is a plain loop of steps, its dropout stream reseeded with the
chunk's index as the TPU script folds it in.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

TRACKED = ("total", "loss_ce", "loss/mano/kp2d/r", "loss/mano/kp3d/r", "loss/mano/pose/r",
           "loss/object/kp3d", "loss/object/rot", "loss/object/radian", "loss/cd")


def setup(args):
    """(device, the MANO hands and the object bank on it)."""
    from uvhand_tpu_torch.device import resolve_device
    from uvhand_tpu_torch.geometry import mano, objects

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device, (mano.synthetic_mano(0, True, device=device),
                    mano.synthetic_mano(1, False, device=device),
                    objects.synthetic_object_bank(2, device=device))


def frame_batches(root, args, n_batches, seed=0, render_gt=False):
    """`n_batches` batches of `args.batch` frames of a synthetic root written at `root`."""
    from uvhand_tpu_torch.data import arctic
    from uvhand_tpu_torch.data.loader import DataLoader
    from uvhand_tpu_torch.geometry import objects

    bank = objects.synthetic_object_bank(2, device="cpu")
    arctic.make_synthetic_root(root, num_seqs=2, frames=(args.batch * n_batches + 1) // 2,
                               views=1, seed=seed, obj_bank=bank, render_gt=render_gt)
    ds = arctic.ArcticDataset(root, "p1", "train", img_res=args.img_res,
                              kp3d_cano=bank.kp_bottom.numpy())
    dl = DataLoader(ds, args.batch, shuffle=False, seed=0)
    try:
        it = iter(dl)
        return [next(it) for _ in range(n_batches)]
    finally:
        dl.close()


def build(args, device, **model_kw):
    from uvhand_tpu_torch.models.detr import UVHandDETR

    return UVHandDETR(num_queries=args.num_queries, d_model=args.hidden_dim, n_heads=args.nheads,
                      num_encoder_layers=args.enc_layers, num_decoder_layers=args.dec_layers,
                      dim_feedforward=args.dim_feedforward, compute_dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0), device=device, **model_kw)


def train_variant(name, model, world, batches, args, device, tracked):
    """`args.chunks` chunks of `args.scan` fused steps, step i of a chunk on
    batch i % len(batches) -> (the per-step curves of the `tracked` terms
    the loss has, wall seconds)."""
    from uvhand_tpu_torch import engine
    from uvhand_tpu_torch.train.state import create_optimizer

    gen = torch.Generator(device=device)
    step = engine.make_fused_train_step(model, *world, create_optimizer(model, lr=2e-4),
                                        img_res=float(args.img_res), generator=gen,
                                        device=device)
    batches = [engine.to_device(b, device, engine.TRAIN_KEYS) for b in batches]
    chunks = []
    t0 = time.perf_counter()
    for c in range(args.chunks):
        gen.manual_seed(c)  # the TPU script's fold_in(rng, c)
        rows = [step(batches[i % len(batches)]) for i in range(args.scan)]
        curves = {k: torch.stack([r[k] for r in rows]).float().cpu().numpy()
                  for k in tracked if k in rows[0]}
        if not all(np.isfinite(v).all() for v in curves.values()):
            raise FloatingPointError(f"{name} chunk {c}: non-finite losses")
        chunks.append(curves)
        print(f"  {name} chunk {c}: steps {c * args.scan}-{(c + 1) * args.scan - 1} "
              + " ".join(f"{k.split('/')[-1]}={v.mean():.4f}" for k, v in curves.items()),
              flush=True)
    dt = time.perf_counter() - t0
    return {k: np.concatenate([ch[k] for ch in chunks]) for k in chunks[0]}, dt


def heldout(name, model, world, eval_batches, args, device):
    """nanmean of each per-frame metric of `engine.make_eval_step` over the batches."""
    from uvhand_tpu_torch import engine

    step = engine.make_eval_step(model, *world, float(args.img_res), device=device)
    rows = {}
    for b in eval_batches:
        for k, v in step(b).items():
            rows.setdefault(k, []).append(v.double().cpu().numpy())
    out = {k: float(np.nanmean(np.concatenate(v))) for k, v in rows.items()}
    print(f"  {name} held-out: " + " ".join(f"{k}={v}" for k, v in out.items()), flush=True)
    return out


def ratios(results, names):
    """The last chunk's means of each variant over the first variant's."""
    base = results[names[0]]["last60_mean"]
    return {f"last60_ratio_{n}_over_{names[0]}": {
        k: results[n]["last60_mean"][k] / max(base[k], 1e-9) for k in base} for n in names[1:]}


def get_args_parser():
    from uvhand_tpu_torch.bench import get_args_parser as widths

    ap = argparse.ArgumentParser("uvhand_tpu_torch.scripts.ab_enc_lite", parents=[widths()],
                                 add_help=False, description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", type=int, default=20, help="chunks of --scan steps a variant")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--scan", type=int, default=60)
    ap.add_argument("--eval_metrics", action="store_true",
                    help="rendered-GT roots; train on --train_batches, score a held-out root")
    ap.add_argument("--train_batches", type=int, default=4)
    ap.add_argument("--variants", default="dense,lite3",
                    help="comma list: dense | liteK (K = enc_lite_hi_every)")
    ap.add_argument("--out", default="", help="a directory for each variant's curves (.npz)")
    return ap


def main(argv=None) -> dict:
    args = get_args_parser().parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="uvhand_ab_") as tmp:
        return run(args, tmp)


def run(args, tmp: str) -> dict:
    """The study, its synthetic roots written under `tmp`."""
    device, world = setup(args)
    batches = frame_batches(os.path.join(tmp, "train"), args,
                            args.train_batches if args.eval_metrics else 1,
                            render_gt=args.eval_metrics)
    eval_batches = frame_batches(os.path.join(tmp, "eval"), args, 2, seed=1,
                                 render_gt=True) if args.eval_metrics else []
    results = {}
    for name in args.variants.split(","):
        if name == "dense":
            kw = {}
        elif name.startswith("lite"):
            kw = dict(enc_lite=True, enc_lite_hi_every=int(name[4:] or 3))
        else:
            raise ValueError(f"variant {name!r}: dense or liteK")
        model = build(args, device, **kw)
        curve, dt = train_variant(name, model, world, batches, args, device, TRACKED)
        results[name] = {
            "chunk_means": {k: v.reshape(args.chunks, args.scan).mean(1).tolist()
                            for k, v in curve.items()},
            "last60_mean": {k: float(v[-args.scan:].mean()) for k, v in curve.items()},
            "steps": int(curve["total"].size), "wall_s": dt}
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            np.savez(os.path.join(args.out, f"ab_enc_lite_{name}.npz"), **curve)
        if args.eval_metrics:
            results[name]["heldout_metrics"] = heldout(name, model, world, eval_batches, args,
                                                       device)
    names = list(results)
    summary = {"metric": ("ab_enc_lite_heldout_metrics" if args.eval_metrics
                          else "ab_enc_lite_memorization"), "variants": names}
    summary.update(ratios(results, names))
    summary.update(results)
    if args.eval_metrics:
        summary["heldout"] = {n: results[n]["heldout_metrics"] for n in names}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
