"""GT preprocessing of the plain reference: raw ARCTIC targets -> the
target schema the criterion and the metrics read (object FK, the rigid fit
into object-canonical space, MANO FK, the least-squares camera translation,
weak-perspective cams, the hand <-> object nearest-point fields).

A frozen copy of the port's `data/process.py`; it imports nothing of the
port.
"""

from __future__ import annotations

from typing import Dict

import torch

from .geometry import (MANOModel, ObjectBank, mano_forward, object_forward,
                       perspective_to_weak_perspective, rigid_transform_batch,
                       solve_rigid_transform, unnormalize_kp2d)


def estimate_translation_k(
    S: torch.Tensor,  # (B, N, 3) 3D points (object-canonical space)
    kp2d: torch.Tensor,  # (B, N, 2) pixel coords
    K: torch.Tensor,  # (B, 3, 3)
) -> torch.Tensor:
    """Least-squares camera translation (unit confidences), batched."""
    B, N, _ = S.shape
    f = torch.stack([K[:, 0, 0], K[:, 1, 1]], -1)  # (B, 2)
    c = torch.stack([K[:, 0, 2], K[:, 1, 2]], -1)

    Z = S[..., 2:]
    XY = S[..., :2]
    # two rows per point: [f_x, 0, cx - u], [0, f_y, cy - v]
    zeros = torch.zeros(B, N, dtype=S.dtype, device=S.device)
    Qx = torch.stack([f[:, None, 0] + zeros, zeros, c[:, None, 0] - kp2d[..., 0]], -1)
    Qy = torch.stack([zeros, f[:, None, 1] + zeros, c[:, None, 1] - kp2d[..., 1]], -1)
    Q = torch.stack([Qx, Qy], 2)  # (B, N, 2, 3)
    rhs = (kp2d - c[:, None]) * Z - f[:, None] * XY  # (B, N, 2)

    Qw = Q.reshape(B, 2 * N, 3)
    cw = rhs.reshape(B, 2 * N)
    A = Qw.transpose(1, 2) @ Qw
    b = torch.einsum("bri,br->bi", Qw, cw)
    return torch.linalg.solve(A, b[..., None])[..., 0]


def nearest_point_fields(src: torch.Tensor, dst: torch.Tensor, dst_mask: torch.Tensor):
    """For each src point: distance to, and index of, the nearest valid dst
    point, from |s - d|^2 = |s|^2 + |d|^2 - 2 s.d."""
    d2 = ((src ** 2).sum(-1)[:, :, None] + (dst ** 2).sum(-1)[:, None, :]
          - 2 * src @ dst.transpose(1, 2))
    d2 = torch.where(dst_mask[:, None, :] > 0, d2, torch.inf)
    d2_min, idx = d2.min(-1)
    return torch.sqrt(d2_min.clamp(min=0.0)), idx.to(torch.int32)


def process_targets(
    targets: Dict[str, torch.Tensor],
    mano_r: MANOModel,
    mano_l: MANOModel,
    obj_bank: ObjectBank,
    img_res: float = 224.0,
) -> Dict[str, torch.Tensor]:
    """Add camera-space GT, weak-perspective cams and contact fields.

    Required keys: mano.pose.r/l (B, 48), mano.beta.r/l (B, 10),
    mano.j3d.full.r/l (B, 21, 3), object.kp3d.full.b (B, 16, 3),
    object.kp2d.norm.b (B, 16, 2), object.rot (B, 3), object.radian (B,),
    query_idx (B,), intrinsics (B, 3, 3)."""
    t = dict(targets)
    K = t["intrinsics"]

    obj = object_forward(obj_bank, t["object.radian"], t["object.rot"].reshape(-1, 3),
                         t["query_idx"])
    nk = obj["kp3d"].shape[1] // 2
    kp3d_b_cano = obj["kp3d"][:, nk:]

    # camera space -> object canonical space rigid fit
    R0, T0 = solve_rigid_transform(t["object.kp3d.full.b"], kp3d_b_cano)
    j3d_r0 = rigid_transform_batch(t["mano.j3d.full.r"], R0, T0)
    j3d_l0 = rigid_transform_batch(t["mano.j3d.full.l"], R0, T0)

    def mano_fk(model, pose, beta):
        return mano_forward(model, pose[:, :3], pose[:, 3:], beta)

    v_r, j_r = mano_fk(mano_r, t["mano.pose.r"], t["mano.beta.r"])
    v_l, j_l = mano_fk(mano_l, t["mano.pose.l"], t["mano.beta.l"])
    root_cano_r = j_r[:, 0]
    root_cano_l = j_l[:, 0]

    v_r = v_r + (j3d_r0 - j_r).mean(1)[:, None]
    v_l = v_l + (j3d_l0 - j_l).mean(1)[:, None]
    j_r, j_l = j3d_r0, j3d_l0

    kp2d_b = unnormalize_kp2d(t["object.kp2d.norm.b"], img_res)
    transl = estimate_translation_k(kp3d_b_cano, kp2d_b, K)

    v_r = v_r + transl[:, None]
    v_l = v_l + transl[:, None]
    j_r = j_r + transl[:, None]
    j_l = j_l + transl[:, None]
    v_o = obj["v"] + transl[:, None]

    cam_t_r = j_r[:, 0] - root_cano_r
    cam_t_l = j_l[:, 0] - root_cano_l
    avg_f = (K[:, 0, 0] + K[:, 1, 1]) / 2.0

    t["mano.cam_t.r"] = cam_t_r
    t["mano.cam_t.l"] = cam_t_l
    t["object.cam_t"] = transl
    t["mano.cam_t.wp.r"] = perspective_to_weak_perspective(cam_t_r, avg_f, img_res)
    t["mano.cam_t.wp.l"] = perspective_to_weak_perspective(cam_t_l, avg_f, img_res)
    t["object.cam_t.wp"] = perspective_to_weak_perspective(transl, avg_f, img_res)
    t["mano.v3d.cam.r"] = v_r
    t["mano.v3d.cam.l"] = v_l
    t["mano.j3d.cam.r"] = j_r
    t["mano.j3d.cam.l"] = j_l
    t["object.kp3d.cam"] = obj["kp3d"] + transl[:, None]
    t["object.bbox3d.cam"] = obj["bbox3d"] + transl[:, None]
    t["object.v.cam"] = v_o
    t["object.v_len"] = obj["v_len"]
    t["object.diameter"] = obj["diameter"]
    t["object.parts_ids"] = obj["parts_ids"]
    if "object.kp2d.norm.t" in t:
        t["object.kp2d.norm"] = torch.cat(
            [t["object.kp2d.norm.t"], t["object.kp2d.norm.b"]], 1)

    # contact fields (prepare_interfield)
    t["dist.ro"], t["idx.ro"] = nearest_point_fields(v_r, v_o, obj["mask"])
    t["dist.lo"], t["idx.lo"] = nearest_point_fields(v_l, v_o, obj["mask"])
    # object -> hand direction
    hand_mask = torch.ones(v_r.shape[:2], dtype=v_r.dtype, device=v_r.device)
    t["dist.or"], t["idx.or"] = nearest_point_fields(v_o, v_r, hand_mask)
    t["dist.ol"], t["idx.ol"] = nearest_point_fields(v_o, v_l, hand_mask)
    return t
