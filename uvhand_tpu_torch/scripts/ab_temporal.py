"""A/B study of the temporal heads against the plain model: port of
`scripts/ab_temporal.py`.

    python -m uvhand_tpu_torch.scripts.ab_temporal [--window 8] [--chunks 12]
        [--batch 16] [--scan 60] [--variants none,lstm,vivit] [--device cpu]
        [--hidden_dim 64 ...]

Window training (`TempoTrainDataset`, every frame's targets,
`collate_tempo_train(split_window=True)`: batch // window windows of
`--window` frames a step) with `temporal_head` none, lstm or vivit, each
variant from the same seed on the same data for the same steps: 4 batches
of one long rendered-GT synthetic sequence (`render_gt=True`), cycled
within each chunk of `--scan` fused steps (bf16 compute, AdamW lr 2e-4).
It prints each chunk's mean of the tracked loss terms (the temporal head's
own camera terms among them, where a bad refinement spikes) and each
variant's held-out metrics through `engine.make_eval_step` on 2 window
batches of another rendered sequence (seed 1), which the temporal heads
refine across each window as the arctic_lstm eval does. The last line is
the summary, with the TPU script's keys (`ab_temporal.py:162`): "metric",
"window", "variants", "last60_ratio_<variant>_over_<first>", and each
variant's {"last60_mean", "steps", "wall_s", "heldout_metrics"}. "none" is
the baseline the heads must not lose to; SmoothNet stays the separate
post-hoc stage.

As in `ab_enc_lite`, a chunk is a plain loop of steps, not the TPU
script's `lax.scan` (which was there for its compile cache; the port
compiles nothing).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile

from uvhand_tpu_torch.scripts.ab_enc_lite import (build, heldout, ratios, setup,
                                                  train_variant)

TRACKED = ("total", "loss_ce", "loss/mano/kp2d/r", "loss/mano/kp3d/r", "loss/mano/pose/r",
           "loss/object/kp3d", "loss/object/rot", "loss/cd", "loss/mano/cam_t/r",
           "loss/object/transl", "loss/mano/cam_t/r/temporal", "loss/object/transl/temporal")


def window_batches(root, args, n_batches, seed):
    """`n_batches` window batches of one rendered-GT sequence written at `root`."""
    from uvhand_tpu_torch.data import arctic
    from uvhand_tpu_torch.data.loader import DataLoader
    from uvhand_tpu_torch.geometry import objects

    T = args.window
    bank = objects.synthetic_object_bank(2, device="cpu")
    arctic.make_synthetic_root(root, num_seqs=1, frames=max(args.batch * n_batches, T + 22),
                               views=1, seed=seed, obj_bank=bank, render_gt=True)
    ds = arctic.ArcticDataset(root, "p1", "train", img_res=args.img_res,
                              kp3d_cano=bank.kp_bottom.numpy())
    dl = DataLoader(arctic.TempoTrainDataset(ds, T, split_window=True),
                    max(args.batch // T, 1), shuffle=False, seed=0,
                    collate_fn=functools.partial(arctic.collate_tempo_train, split_window=True))
    try:
        it = iter(dl)
        return [next(it) for _ in range(n_batches)]
    finally:
        dl.close()


def get_args_parser():
    from uvhand_tpu_torch.bench import get_args_parser as widths

    ap = argparse.ArgumentParser("uvhand_tpu_torch.scripts.ab_temporal", parents=[widths()],
                                 add_help=False, description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", type=int, default=12)
    ap.add_argument("--batch", type=int, default=16,
                    help="frames a step (windows = batch // window)")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--scan", type=int, default=60)
    ap.add_argument("--variants", default="none,lstm,vivit")
    return ap


def main(argv=None) -> dict:
    args = get_args_parser().parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="uvhand_abt_") as tmp:
        return run(args, tmp)


def run(args, tmp: str) -> dict:
    """The study, its synthetic roots written under `tmp`."""
    device, world = setup(args)
    batches = window_batches(os.path.join(tmp, "train"), args, 4, seed=0)
    eval_batches = window_batches(os.path.join(tmp, "eval"), args, 2, seed=1)
    results = {}
    for name in args.variants.split(","):
        if name not in ("none", "lstm", "vivit"):
            raise ValueError(f"variant {name!r}: none, lstm or vivit")
        model = build(args, device, temporal_head=name,
                      temporal_window=args.window if name != "none" else 0)
        curve, dt = train_variant(name, model, world, batches, args, device, TRACKED)
        results[name] = {"last60_mean": {k: float(v[-args.scan:].mean())
                                         for k, v in curve.items()},
                         "steps": int(curve["total"].size), "wall_s": dt,
                         "heldout_metrics": heldout(name, model, world, eval_batches, args,
                                                    device)}
    names = list(results)
    summary = {"metric": "ab_temporal_heads", "window": args.window, "variants": names}
    summary.update(ratios(results, names))
    summary.update(results)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
