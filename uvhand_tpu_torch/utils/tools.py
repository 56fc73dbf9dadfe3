"""Training and eval tools.

Port of `uvhand_tpu/utils/tools.py` (the reference's `util/tools.py`):
`arctic_smoothing` (the eval-time `--iter` smoothing), `create_loss_dict`
(the loss groups a log line shows), `create_arctic_score_dict` and
`extract_epoch`.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def arctic_smoothing(target, count: int) -> torch.Tensor:
    """(B, T, C) -> iterative pairwise smoothing along T, flattened (B*T, C).

    The reference recursion: for i in 0..T-2, x[i+1] = x[i] = (x[i] + x[i+1]) / 2,
    applied sequentially `count` times; the running average is taken in
    that order (as the JAX package's scan takes it), so the final sequence
    is [a_1, ..., a_{T-1}, a_{T-1}]."""
    x = torch.as_tensor(target)
    B, T, C = x.shape
    for _ in range(count):
        prev, rest = x[:, 0], []
        for t in range(1, T):
            prev = (prev + x[:, t]) / 2.0
            rest.append(prev)
        rest = torch.stack(rest, 1) if rest else x[:, :0]
        x = torch.cat([rest, rest[:, -1:]], 1)[:, :T]
    return x.reshape(-1, C)


LOSS_GROUPS = {
    "loss_obj_smt": ["loss/object/v3d_smoothing"],
    "loss_ce": ["loss_ce"],
    "loss_CDev": ["loss/cd"],
    "loss_smooth": ["loss/smooth/2d", "loss/smooth/3d"],
    "loss_penetr": ["loss/penetr"],
    "loss_mano": ["loss/mano/pose/r", "loss/mano/beta/r", "loss/mano/pose/l", "loss/mano/beta/l"],
    "loss_rot": ["loss/object/radian", "loss/object/rot"],
    "loss_transl": ["loss/mano/transl/l", "loss/object/transl"],
    "loss_kp": [
        "loss/mano/kp2d/r", "loss/mano/kp3d/r", "loss/mano/kp2d/l", "loss/mano/kp3d/l",
        "loss/object/kp2d", "loss/object/kp3d",
    ],
    "loss_cam": ["loss/mano/cam_t/r", "loss/mano/cam_t/l", "loss/object/cam_t"],
    "loss_hand_key": ["loss_hand_keypoint"],
    "loss_obj_key": ["loss_obj_keypoint"],
    "loss_acc_h": ["acc/h"],
    "loss_acc_o": ["acc/o"],
}

MODE_ITEMS = {
    "baseline": ["loss_ce", "loss_CDev", "loss_obj_smt", "loss_mano", "loss_rot",
                 "loss_transl", "loss_kp", "loss_cam", "loss_hand_key", "loss_obj_key"],
    "dino": ["loss_ce", "loss_CDev", "loss_penetr", "loss_mano", "loss_rot",
             "loss_transl", "loss_kp", "loss_cam", "loss_hand_key", "loss_obj_key"],
    "smoothnet": ["loss_CDev", "loss_acc_h", "loss_acc_o"],
}


def create_loss_dict(loss_value, loss_out: Dict, round_value=False,
                     mode="baseline") -> Dict[str, float]:
    """The total and each loss group of `mode`, summed over its terms in
    `loss_out` (floats or tensors)."""
    res = {"loss": float(loss_out.get("loss", loss_out.get("total", loss_value)))}
    for group in MODE_ITEMS.get(mode, MODE_ITEMS["baseline"]):
        vals = [float(loss_out[k]) for k in LOSS_GROUPS.get(group, []) if k in loss_out]
        if vals:
            v = float(np.sum(vals))
            res[group] = round(v, 4) if round_value else v
    return res


def create_arctic_score_dict(stats: Dict) -> Dict[str, float]:
    keys = ["cdev/ho", "mrrpe/r/l", "mrrpe/r/o", "mpjpe/ra/h", "aae",
            "success_rate/0.05", "acc/h", "acc/o", "mdev/h"]
    return {k: float(stats[k]) for k in keys if k in stats}


def extract_epoch(path: str) -> int:
    m = re.search(r"(\d+)(?:\.pth)?$", path.rstrip("/"))
    return int(m.group(1)) if m else -1
