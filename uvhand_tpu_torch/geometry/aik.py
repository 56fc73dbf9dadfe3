"""Adaptive inverse kinematics: 21 hand joints -> 48-d MANO axis-angle pose.

Port of `uvhand_tpu/geometry/aik.py` (the reference's `adaptive_IK`,
AIK/AIK_torch.py, and its config). The reference loops over the batch in
Python; here every step of the 15-bone kinematic recursion is one batched
3x3 op over the whole batch (the recursion over the bones is a fixed,
unrolled chain).

Joint order is the SNAP/bihand 21-keypoint order:
  0 wrist, 1-4 thumb, 5-8 index, 9-12 middle, 13-16 ring, 17-20 pinky.
The input is root-aligned to the template wrist (the reference sets
q[0] = T[0]). Twist about a bone's axis is unobservable from joint
positions and set to 0, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .rotations import axis_angle_to_matrix, matrix_to_axis_angle

SNAP_PARENT = (
    0, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19,
)
KINEMATIC_TREE = (2, 3, 4, 6, 7, 8, 10, 11, 12, 14, 15, 16, 18, 19, 20)
# SNAP joint id -> MANO pose slot (1..15); slot 0 is the global orientation
ID2ROT = {
    2: 13, 3: 14, 4: 15,
    6: 1, 7: 2, 8: 3,
    10: 4, 11: 5, 12: 6,
    14: 10, 15: 11, 16: 12,
    18: 7, 19: 8, 20: 9,
}
PALM_JOINTS = (1, 5, 9, 13, 17)  # finger bases used for the global fit

# SNAP hand template keypoints (mm), bihand/SNAP lineage (AIK_config.py)
TEMPLATE_RIGHT = np.array(
    [
        [95.66992, 6.383429, 6.186305],
        [71.58023, -9.138906, 31.999151],
        [51.946987, -8.24762, 55.698708],
        [29.729244, -13.680591, 70.222824],
        [2.2312577, -18.095005, 90.9145],
        [7.5726805, 1.1830721, 26.872293],
        [-25.106222, 5.192427, 29.089361],
        [-47.262135, 3.894005, 28.975246],
        [-70.5249, 4.6119733, 33.024513],
        [1.0094867, 4.9044657, 2.8287644],
        [-30.173185, 6.765794, -2.7657442],
        [-53.077824, 5.5136905, -6.7102585],
        [-78.99283, 6.146649, -12.040861],
        [13.934374, 2.4260077, -20.486887],
        [-14.3799, 4.493015, -25.585424],
        [-37.90041, 2.8049028, -33.219242],
        [-60.804226, 7.343061, -40.20221],
        [26.882961, -3.5568998, -37.023037],
        [9.868553, -3.495075, -49.521812],
        [-5.9983487, -4.1862307, -59.853718],
        [-21.898844, -1.6281177, -70.131676],
    ],
    np.float32,
)
TEMPLATE_LEFT = TEMPLATE_RIGHT * np.array([-1.0, 1.0, 1.0], np.float32)


def _template(template, side, like: torch.Tensor) -> torch.Tensor:
    if template is None:
        template = TEMPLATE_RIGHT if side == "right" else TEMPLATE_LEFT
    return torch.as_tensor(template, dtype=like.dtype, device=like.device)


def _matvec(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R (B, 3, 3) @ v (B, 3) or (3,) -> (B, 3)."""
    return (R @ v[..., None])[..., 0]


def _swing_matrix(delta_t: torch.Tensor, delta_p: torch.Tensor) -> torch.Tensor:
    """Rotations (B, 3, 3) taking template bones delta_t onto predicted
    bones delta_p, both (B, 3)."""
    axis_raw = torch.linalg.cross(delta_t, delta_p, dim=-1)
    axis = axis_raw / (torch.linalg.norm(axis_raw, dim=-1, keepdim=True) + 1e-8)
    denom = ((torch.linalg.norm(delta_t, dim=-1) + 1e-8)
             * (torch.linalg.norm(delta_p, dim=-1) + 1e-8))
    cos_a = ((delta_t * delta_p).sum(-1) / denom).clamp(-1.0, 1.0)
    return axis_angle_to_matrix(axis * torch.arccos(cos_a)[:, None])


def _global_fit(T: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Arun fit on the 5 palm bones (AIK_torch.py:118-141). T (21, 3),
    P (B, 21, 3) -> (B, 3, 3)."""
    idx = list(PALM_JOINTS)
    T0 = (T[idx] - T[0]).T  # (3, 5)
    P0 = (P[:, idx] - P[:, :1]).transpose(1, 2)  # (B, 3, 5)
    H = torch.einsum("in,bjn->bij", T0, P0)
    U, S, Vt = torch.linalg.svd(H)
    V = Vt.transpose(1, 2)
    det = torch.linalg.det(V @ U.transpose(1, 2))
    # the reference flips only when det == -1 AND H is near-singular
    flip = (det < 0) & (S.abs() < 1e-4).any(-1)
    sign = torch.ones_like(V[:, 0])  # (B, 3): the third column's sign
    sign[:, 2] = torch.where(flip, -1.0, 1.0)
    return (V * sign[:, None, :]) @ U.transpose(1, 2)


def adaptive_ik(P: torch.Tensor, template=None, side: str = "right") -> torch.Tensor:
    """Batched IK: P (B, 21, 3) root-aligned joints -> (B, 48) MANO pose."""
    T = _template(template, side, P)
    B = P.shape[0]
    R0 = _global_fit(T, P)
    R = [None] * 21
    R[0] = R0
    for k in PALM_JOINTS:
        R[k] = R0
    q = [None] * 21
    q[0] = T[0].expand(B, 3)
    local = {}
    for k in KINEMATIC_TREE:
        pa = SNAP_PARENT[k]
        if q[pa] is None:
            q[pa] = _matvec(R[pa], T[pa] - T[SNAP_PARENT[pa]]) + q[SNAP_PARENT[pa]]
        delta_p = _matvec(R[pa].transpose(1, 2), P[:, k] - q[pa])
        local[k] = _swing_matrix((T[k] - T[pa]).expand(B, 3), delta_p)
        R[k] = R[pa] @ local[k]
    pose_R = [R0] + [None] * 15
    for k, slot in ID2ROT.items():
        pose_R[slot] = local[k]
    return matrix_to_axis_angle(torch.stack(pose_R, 1)).reshape(B, 48)


def aik_fk(pose48: torch.Tensor, template=None, side: str = "right") -> torch.Tensor:
    """Forward kinematics in the IK's own convention (for round trips):
    q[k] = q[parent] + R[k] @ (T[k] - T[parent]), R the cumulative
    rotations. pose48 (B, 48) -> (B, 21, 3)."""
    T = _template(template, side, pose48)
    B = pose48.shape[0]
    mats = axis_angle_to_matrix(pose48.reshape(B, 16, 3))
    R = [None] * 21
    R[0] = mats[:, 0]
    for k in PALM_JOINTS:
        R[k] = mats[:, 0]
    for k in KINEMATIC_TREE:
        R[k] = R[SNAP_PARENT[k]] @ mats[:, ID2ROT[k]]
    q = [T[0].expand(B, 3)] + [None] * 20
    for k in range(1, 21):
        pa = SNAP_PARENT[k]
        q[k] = q[pa] + _matvec(R[k], T[k] - T[pa])
    return torch.stack(q, 1)
