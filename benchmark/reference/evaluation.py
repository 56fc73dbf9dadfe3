"""Decode and per-frame metrics of the plain reference: the selected
queries' parameters through MANO and the object bank into camera space, and
the five per-frame metrics (aae, mpjpe.ra, mrrpe, success_rate, cdev).

A frozen copy of the port's `evaluation/decode.py` and
`evaluation/metrics.py`; it imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .geometry import (MANOModel, ObjectBank, mano_forward, normalize_kp2d, object_forward,
                       project2d, weak_perspective_to_perspective)


def decode_predictions(
    selected: Dict[str, torch.Tensor],
    targets_meta: Dict[str, torch.Tensor],  # needs intrinsics, query_idx
    mano_r: MANOModel,
    mano_l: MANOModel,
    obj_bank: ObjectBank,
    img_res: float = 224.0,
) -> Dict[str, torch.Tensor]:
    K = targets_meta["intrinsics"]
    avg_f = (K[:, 0, 0] + K[:, 1, 1]) / 2.0
    out: Dict[str, torch.Tensor] = {}

    for side, model in (("r", mano_r), ("l", mano_l)):
        pose = selected[f"pose.{side}"]
        beta = selected[f"beta.{side}"]
        wp = selected[f"root.{side}"]
        cam_t = weak_perspective_to_perspective(wp, avg_f, img_res)
        verts, joints = mano_forward(model, pose[:, :3], pose[:, 3:], beta)
        j3d = joints + cam_t[:, None]
        out[f"mano.cam_t.wp.{side}"] = wp
        out[f"mano.cam_t.{side}"] = cam_t
        out[f"mano.joints3d.{side}"] = joints
        out[f"mano.vertices.{side}"] = verts
        out[f"mano.j3d.cam.{side}"] = j3d
        out[f"mano.v3d.cam.{side}"] = verts + cam_t[:, None]
        out[f"mano.j2d.norm.{side}"] = normalize_kp2d(
            project2d(K, j3d), img_res)
        out[f"mano.beta.{side}"] = beta
        out[f"mano.pose.{side}"] = pose

    wp_o = selected["root.o"]
    cam_t_o = weak_perspective_to_perspective(wp_o, avg_f, img_res)
    obj = object_forward(obj_bank, selected["obj_rad"], selected["obj_rot"],
                         targets_meta["query_idx"])
    kp3d_cam = obj["kp3d"] + cam_t_o[:, None]
    nk = kp3d_cam.shape[1] // 2
    kp2d = normalize_kp2d(project2d(K, kp3d_cam), img_res)
    out["object.rot"] = selected["obj_rot"]
    out["object.radian"] = selected["obj_rad"]
    out["object.cam_t.wp"] = wp_o
    out["object.cam_t"] = cam_t_o
    out["object.kp3d"] = obj["kp3d"]
    out["object.bbox3d"] = obj["bbox3d"]
    out["object.kp3d.cam"] = kp3d_cam
    out["object.bbox3d.cam"] = obj["bbox3d"] + cam_t_o[:, None]
    out["object.kp2d.norm"] = kp2d
    out["object.kp2d.norm.t"] = kp2d[:, :nk]
    out["object.kp2d.norm.b"] = kp2d[:, nk:]
    out["object.v.cam"] = obj["v"] + cam_t_o[:, None]
    out["object.v_len"] = obj["v_len"]
    out["object.parts_ids"] = obj["parts_ids"]
    out["object.diameter"] = obj["diameter"]
    return out

NAN = float("nan")


def compute_joint3d_error(gt, pred, valid) -> torch.Tensor:
    """(B, J, 3) -> (B, J) distances; invalid rows NaN."""
    dist = torch.sqrt(((gt - pred) ** 2).sum(2))
    return torch.where(valid[:, None] > 0, dist, NAN)


def compute_mrrpe(root_a_gt, root_b_gt, root_a_pred, root_b_pred, valid):
    err = torch.sqrt((((root_b_pred - root_a_pred) - (root_b_gt - root_a_gt)) ** 2).sum(1))
    return torch.where(valid > 0, err, NAN)


def compute_arti_deg_error(pred_radian, gt_radian):
    return (pred_radian - gt_radian).abs() / math.pi * 180.0


def object_bottom_root(v_cam, parts_ids):
    """Mean of the bottom-part (parts_ids == 2) vertices. -> (B, 3)."""
    m = (parts_ids == 2).to(v_cam.dtype)
    return (v_cam * m[..., None]).sum(1) / m.sum(1).clamp(min=1)[:, None]


def eval_degree(pred, targets) -> Dict[str, torch.Tensor]:
    err = compute_arti_deg_error(pred["object.radian"].reshape(-1),
                                 targets["object.radian"].reshape(-1))
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
