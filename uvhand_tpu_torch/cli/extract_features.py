"""Backbone feature extraction (`--extract`).

Port of `uvhand_tpu/cli/extract_features.py` (the reference's
`extract_feature`, util/tools.py, and the model's backbone hook): runs the
backbone alone (`UVHandDETR(..., return_backbone_features=True)`) and
stores each image's multi-scale maps, so that a precomputed-feature model
(`feature_type="global_fm"` / `"local_fm"`) can be fed without the
backbone. The layout is the reference's:
`{out_dir}/{setup}_2048/{split}/{sid}/{seq}/{view}/{frame}.pkl`, a pickled
list of the 3 maps of one image, NHWC float32 numpy.
"""

from __future__ import annotations

import os
import os.path as op
import pickle

import numpy as np
import torch


def extract_features(model, dataset, out_dir: str, setup: str = "p1", split: str = "train",
                     batch_size: int = 16) -> str:
    """Store the backbone maps of every image of `dataset`; `model` runs on
    the device its parameters are on, in batches of `batch_size` (the last
    padded with its last image). Returns the split's directory."""
    device = next(model.parameters()).device
    model.eval()
    n = len(dataset)
    root = op.join(out_dir, f"{setup}_2048", split)
    os.makedirs(root, exist_ok=True)
    for s in range(0, n, batch_size):
        ids = list(range(s, min(s + batch_size, n)))
        samples = [dataset[i] for i in ids + [ids[-1]] * (batch_size - len(ids))]
        imgs = torch.as_tensor(np.stack([x["images"] for x in samples]), device=device)
        with torch.inference_mode():
            feats = [f.float().cpu().numpy() for f in model(imgs, return_backbone_features=True)]
        for k in range(len(ids)):
            out_p = op.join(root, *samples[k]["imgname"].split("/")[-4:]) + ".pkl"
            os.makedirs(op.dirname(out_p), exist_ok=True)
            with open(out_p, "wb") as f:
                pickle.dump([fm[k] for fm in feats], f)
    return root


def load_feature_maps(root: str, imgnames, setup: str = "p1", split: str = "train"):
    """The stored maps of `imgnames`, stacked per level: a list over the
    levels of (T, H, W, C) numpy arrays (the reference's
    tempo_inference_dataset.py local_fm loading)."""
    out = []
    for name in imgnames:
        p = op.join(root, f"{setup}_2048", split, *name.split("/")[-4:]) + ".pkl"
        with open(p, "rb") as f:
            out.append(pickle.load(f))
    return [np.stack([o[lvl] for o in out], 0) for lvl in range(len(out[0]))]
