"""ARCTIC per-frame evaluation metrics.

Port of the per-batch metrics of `uvhand_tpu/evaluation/metrics.py` (the
reference's `eval_modules.py`): AAE, MPJPE-RA, MRRPE, success rate and
CDev. Each returns one value per frame, NaN where the frame is invalid;
aggregation is a nanmean over frames.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

NAN = float("nan")


def compute_joint3d_error(gt, pred, valid) -> torch.Tensor:
    """(B, J, 3) -> (B, J) distances; invalid rows NaN."""
    dist = torch.sqrt(((gt - pred) ** 2).sum(2))
    return torch.where(valid[:, None] > 0, dist, NAN)


def compute_mrrpe(root_a_gt, root_b_gt, root_a_pred, root_b_pred, valid):
    err = torch.sqrt((((root_b_pred - root_a_pred) - (root_b_gt - root_a_gt)) ** 2).sum(1))
    return torch.where(valid > 0, err, NAN)


def object_bottom_root(v_cam, parts_ids):
    """Mean of the bottom-part (parts_ids == 2) vertices. -> (B, 3)."""
    m = (parts_ids == 2).to(v_cam.dtype)
    return (v_cam * m[..., None]).sum(1) / m.sum(1).clamp(min=1)[:, None]


def eval_degree(pred, targets) -> Dict[str, torch.Tensor]:
    err = (pred["object.radian"].reshape(-1) - targets["object.radian"].reshape(-1)).abs()
    err = err / math.pi * 180.0
    return {"aae": torch.where(targets["is_valid"] > 0, err, NAN)}


def eval_mpjpe_ra(pred, targets) -> Dict[str, torch.Tensor]:
    is_valid = targets["is_valid"]
    lv = targets["left_valid"] * is_valid
    rv = targets["right_valid"] * is_valid

    def ra(x):
        return x - x[:, :1]

    r = compute_joint3d_error(ra(targets["mano.j3d.cam.r"]), ra(pred["mano.j3d.cam.r"]),
                              rv).mean(1)
    l = compute_joint3d_error(ra(targets["mano.j3d.cam.l"]), ra(pred["mano.j3d.cam.l"]),
                              lv).mean(1)
    return {"mpjpe/ra/h": torch.stack([r, l], 1).nanmean(1) * 1000.0}


def eval_mrrpe(pred, targets) -> Dict[str, torch.Tensor]:
    is_valid = targets["is_valid"]
    lv = targets["left_valid"] * is_valid
    rv = targets["right_valid"] * is_valid
    parts = targets["object.parts_ids"]
    root_o_gt = object_bottom_root(targets["object.v.cam"], parts)
    root_o_pred = object_bottom_root(pred["object.v.cam"], parts)
    rl = compute_mrrpe(targets["mano.j3d.cam.r"][:, 0], targets["mano.j3d.cam.l"][:, 0],
                       pred["mano.j3d.cam.r"][:, 0], pred["mano.j3d.cam.l"][:, 0], lv * rv)
    ro = compute_mrrpe(targets["mano.j3d.cam.r"][:, 0], root_o_gt,
                       pred["mano.j3d.cam.r"][:, 0], root_o_pred, rv * is_valid)
    return {"mrrpe/r/l": rl * 1000.0, "mrrpe/r/o": ro * 1000.0}


def eval_v2v_success(pred, targets, alpha: float = 0.05) -> Dict[str, torch.Tensor]:
    parts = targets["object.parts_ids"]
    vmask = (parts > 0).float()
    root_gt = object_bottom_root(targets["object.v.cam"], parts)
    root_pred = object_bottom_root(pred["object.v.cam"], parts)
    d = torch.sqrt((((targets["object.v.cam"] - root_gt[:, None])
                     - (pred["object.v.cam"] - root_pred[:, None])) ** 2).sum(2))
    thresh = targets["object.diameter"][:, None] * alpha
    ok = (d < thresh).float() * vmask
    rate = ok.sum(1) / vmask.sum(1).clamp(min=1)
    rate = torch.where(targets["is_valid"] > 0, rate, NAN)
    return {f"success_rate/{alpha:.2f}": rate * 100.0}


def contact_deviation_metric(v_obj, v_hand, dist, idx, is_valid, hand_valid):
    """Per-frame mean displacement of the GT contacts; NaN when a frame has
    no contact or is invalid."""
    valid = hand_valid * is_valid
    corres = torch.gather(v_obj, 1, idx.long()[:, :, None].expand(-1, -1, 3))
    disp = torch.sqrt(((corres - v_hand) ** 2).sum(-1))
    contact = (dist <= 3e-3).float() * valid[:, None]
    n = contact.sum(1)
    per = (disp * contact).sum(1) / n.clamp(min=1)
    return torch.where(n > 0, per, NAN)


def eval_contact_deviation(pred, targets) -> Dict[str, torch.Tensor]:
    ro = contact_deviation_metric(pred["object.v.cam"], pred["mano.v3d.cam.r"],
                                  targets["dist.ro"], targets["idx.ro"],
                                  targets["is_valid"], targets["right_valid"])
    lo = contact_deviation_metric(pred["object.v.cam"], pred["mano.v3d.cam.l"],
                                  targets["dist.lo"], targets["idx.lo"],
                                  targets["is_valid"], targets["left_valid"])
    return {"cdev/ho": torch.stack([ro, lo], 1).nanmean(1) * 1000.0}


eval_fn_dict = {
    "aae": eval_degree,
    "mpjpe.ra": eval_mpjpe_ra,
    "mrrpe": eval_mrrpe,
    "success_rate": eval_v2v_success,
    "cdev": eval_contact_deviation,
}


def measure_error(pred, targets,
                  metrics=("aae", "mpjpe.ra", "mrrpe", "success_rate", "cdev")):
    out: Dict[str, torch.Tensor] = {}
    for m in metrics:
        out.update(eval_fn_dict[m](pred, targets))
    return out
