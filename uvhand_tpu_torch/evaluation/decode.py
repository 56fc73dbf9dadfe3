"""Decode selected-query predictions into camera-space meshes and keypoints.

Port of `uvhand_tpu/evaluation/decode.py` (the reference's `make_output`:
MANOHead + ArtiHead on the per-image selected queries), emitting the
`mano.*` / `object.*` prediction dict the metrics read.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..geometry import camera
from ..geometry.mano import MANOModel, mano_forward
from ..geometry.objects import ObjectBank, object_forward


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
        cam_t = camera.weak_perspective_to_perspective(wp, avg_f, img_res)
        verts, joints = mano_forward(model, pose[:, :3], pose[:, 3:], beta)
        j3d = joints + cam_t[:, None]
        out[f"mano.cam_t.wp.{side}"] = wp
        out[f"mano.cam_t.{side}"] = cam_t
        out[f"mano.joints3d.{side}"] = joints
        out[f"mano.vertices.{side}"] = verts
        out[f"mano.j3d.cam.{side}"] = j3d
        out[f"mano.v3d.cam.{side}"] = verts + cam_t[:, None]
        out[f"mano.j2d.norm.{side}"] = camera.normalize_kp2d(
            camera.project2d(K, j3d), img_res)
        out[f"mano.beta.{side}"] = beta
        out[f"mano.pose.{side}"] = pose

    wp_o = selected["root.o"]
    cam_t_o = camera.weak_perspective_to_perspective(wp_o, avg_f, img_res)
    obj = object_forward(obj_bank, selected["obj_rad"], selected["obj_rot"],
                         targets_meta["query_idx"])
    kp3d_cam = obj["kp3d"] + cam_t_o[:, None]
    nk = kp3d_cam.shape[1] // 2
    kp2d = camera.normalize_kp2d(camera.project2d(K, kp3d_cam), img_res)
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
