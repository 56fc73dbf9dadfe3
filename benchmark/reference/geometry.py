"""Geometry of the plain reference: rotations, the pinhole and
weak-perspective cameras, MANO linear blend skinning, the object bank and
the rigid fit.

A frozen copy of the port's `geometry/` (rotations.py, camera.py, mano.py,
objects.py, rigid.py) as of the benchmark's first version, trimmed to what
the GT preprocessing, the criterion and the decode read. It imports nothing
of the port.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_EPS = 1e-6



def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Force the real part to be non-negative (q and -q are the same rotation)."""
    return torch.where(q[..., :1] < 0, -q, q)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = torch.unbind(a, -1)
    bw, bx, by, bz = torch.unbind(b, -1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        -1,
    )


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quaternion_apply(q: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate `point` (..., 3) by quaternion `q` (..., 4)."""
    p = torch.cat([torch.zeros_like(point[..., :1]), point], -1)
    return quaternion_multiply(quaternion_multiply(q, p), quaternion_invert(q))[..., 1:]


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    r, i, j, k = torch.unbind(q, -1)
    two_s = 2.0 / torch.sum(q * q, -1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        -1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    angles = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = angles * 0.5
    small = angles.abs() < _EPS
    # sin(x/2)/x, with Taylor 0.5 - x^2/48 near zero
    safe = torch.where(small, torch.ones_like(angles), angles)
    sin_half_over_angle = torch.where(
        small, 0.5 - (angles * angles) / 48.0, torch.sin(half) / safe)
    return torch.cat([torch.cos(half), axis_angle * sin_half_over_angle], -1)


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a subgradient of 0 at x = 0."""
    positive = x > 0
    safe = torch.where(positive, x, torch.ones_like(x))
    return torch.where(positive, torch.sqrt(safe), torch.zeros_like(x))


def one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Shepperd-style extraction: the best-conditioned of 4 candidates."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.unbind(
        matrix.reshape(matrix.shape[:-2] + (9,)), -1)
    q_abs = _sqrt_positive_part(torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        -1,
    ))
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
        ],
        -2,
    )
    candidates = quat_by_rijk / (2.0 * q_abs[..., None].clamp(min=0.1))
    onehot = one_hot(torch.argmax(q_abs, -1), 4, candidates.dtype)
    return standardize_quaternion((candidates * onehot[..., None]).sum(-2))


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(norms, q[..., :1])
    angles = 2.0 * half
    small = angles.abs() < _EPS
    safe = torch.where(small, torch.ones_like(angles), angles)
    sin_half_over_angle = torch.where(
        small, 0.5 - (angles * angles) / 48.0, torch.sin(half) / safe)
    return q[..., 1:] / sin_half_over_angle


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al. continuous 6D -> rotation matrix (Gram-Schmidt)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp(min=_EPS)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / torch.linalg.norm(a2p, dim=-1, keepdim=True).clamp(min=_EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], -2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def euler_angles_to_matrix(euler: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    def axis_rot(axis: str, angle: torch.Tensor) -> torch.Tensor:
        c, s = torch.cos(angle), torch.sin(angle)
        one, zero = torch.ones_like(angle), torch.zeros_like(angle)
        if axis == "X":
            rows = [one, zero, zero, zero, c, -s, zero, s, c]
        elif axis == "Y":
            rows = [c, zero, s, zero, one, zero, -s, zero, c]
        else:
            rows = [c, -s, zero, s, c, zero, zero, zero, one]
        return torch.stack(rows, -1).reshape(angle.shape + (3, 3))

    mats = [axis_rot(c, euler[..., i]) for i, c in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def rotate_about_axis(radian: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Rotation matrix for `radian` (...,) about a fixed unit `axis` (3,)."""
    return axis_angle_to_matrix(radian[..., None] * axis)


def weak_perspective_to_perspective(wp_cam: torch.Tensor, focal_length, img_res,
                                    min_s: float = 0.1) -> torch.Tensor:
    """wp_cam (..., 3) = [s, tx, ty] -> camera translation [tx, ty, tz]."""
    s = wp_cam[..., 0].clamp(min=min_s)
    tz = 2.0 * focal_length / (img_res * s + 1e-9)
    return torch.stack([wp_cam[..., 1], wp_cam[..., 2], tz], -1)


def perspective_to_weak_perspective(cam_t: torch.Tensor, focal_length,
                                    img_res) -> torch.Tensor:
    """cam_t (..., 3) = [tx, ty, tz] -> weak-perspective [s, tx, ty]."""
    s = 2.0 * focal_length / (img_res * cam_t[..., 2] + 1e-9)
    return torch.stack([s, cam_t[..., 0], cam_t[..., 1]], -1)


def project2d(K: torch.Tensor, pts_cam: torch.Tensor) -> torch.Tensor:
    """K (..., 3, 3), pts_cam (..., N, 3) -> pixel coords (..., N, 2)."""
    homo = torch.einsum("...ij,...nj->...ni", K, pts_cam)
    return homo[..., :2] / homo[..., 2:].clamp(min=1e-9)


def normalize_kp2d(kp2d: torch.Tensor, img_res) -> torch.Tensor:
    """Pixel coords -> [-1, 1] (reference convention 2*p/res - 1)."""
    return 2.0 * kp2d / img_res - 1.0


def unnormalize_kp2d(kp2d_norm: torch.Tensor, img_res) -> torch.Tensor:
    return 0.5 * img_res * (kp2d_norm + 1.0)


TIP_VERTEX_IDS = (744, 320, 443, 554, 672)  # thumb, index, middle, ring, pinky

# kinematic parents of the 16 joints (wrist + 3 per finger: index 1-3,
# middle 4-6, pinky 7-9, ring 10-12, thumb 13-15)
MANO_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)

# manopth's visualization / eval order: kinematic + tips -> wrist, then the
# thumb..pinky chains (the reference's manolayer.py:260)
JOINT_REORDER_MANOPTH = (
    0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20,
)

NUM_VERTS = 778
NUM_JOINTS = 16
NUM_SHAPE = 10
NUM_POSE_FEAT = (NUM_JOINTS - 1) * 9  # 135


@dataclasses.dataclass
class MANOModel:
    """MANO parameters as float32 tensors on one device."""

    v_template: torch.Tensor  # (778, 3)
    shapedirs: torch.Tensor  # (778, 3, 10)
    posedirs: torch.Tensor  # (135, 778*3)
    J_regressor: torch.Tensor  # (16, 778)
    lbs_weights: torch.Tensor  # (778, 16)
    hands_mean: torch.Tensor  # (45,)
    faces: np.ndarray | None = None  # (F, 3) int
    is_rhand: bool = True


def _rigid_chain(rot_mats: torch.Tensor, joints: torch.Tensor):
    """Forward-kinematic chain (SMPL batch_rigid_transform semantics).

    rot_mats (B, 16, 3, 3), joints (B, 16, 3) rest joints. Returns posed
    joints (B, 16, 3) and skinning transforms A (B, 16, 4, 4)."""
    B = joints.shape[0]
    parents = list(MANO_PARENTS)
    rel = joints.clone()
    rel[:, 1:] -= joints[:, parents[1:]]
    T_local = torch.zeros(B, NUM_JOINTS, 4, 4, dtype=joints.dtype, device=joints.device)
    T_local[..., :3, :3] = rot_mats
    T_local[..., :3, 3] = rel
    T_local[..., 3, 3] = 1.0
    world = [T_local[:, 0]]
    for j in range(1, NUM_JOINTS):
        world.append(world[parents[j]] @ T_local[:, j])
    T_world = torch.stack(world, 1)  # (B, 16, 4, 4)
    posed_joints = T_world[..., :3, 3]
    # remove the rest-pose joint location: A = T_world [I, -j; 0, 1]
    tj = torch.einsum("bkij,bkj->bki", T_world[..., :3, :3], joints)
    A = T_world.clone()
    A[..., :3, 3] -= tj
    return posed_joints, A


def mano_forward(
    model: MANOModel,
    global_orient: torch.Tensor,  # (B, 3) axis-angle
    hand_pose: torch.Tensor,  # (B, 45) axis-angle
    betas: torch.Tensor,  # (B, 10)
):
    """MANO LBS forward -> (vertices (B, 778, 3), joints (B, 21, 3)), with
    the hands_mean offset added to the hand pose (flat_hand_mean=False, the
    reference's configuration)."""
    B = betas.shape[0]
    full_pose = torch.cat([global_orient, hand_pose + model.hands_mean], -1)
    rot_mats = axis_angle_to_matrix(full_pose.reshape(B, NUM_JOINTS, 3))

    v_shaped = model.v_template + torch.einsum("vcs,bs->bvc", model.shapedirs, betas)
    joints = torch.einsum("jv,bvc->bjc", model.J_regressor, v_shaped)

    # pose blendshapes on (R - I)
    eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, NUM_POSE_FEAT)
    v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(B, NUM_VERTS, 3)

    posed_joints, A = _rigid_chain(rot_mats, joints)

    # skinning: T_v = sum_k w_vk A_k
    T_v = torch.einsum("vk,bkij->bvij", model.lbs_weights, A)
    verts = torch.einsum("bvij,bvj->bvi", T_v[..., :3, :3], v_posed) + T_v[..., :3, 3]

    return verts, torch.cat([posed_joints, verts[:, list(TIP_VERTEX_IDS)]], 1)

OBJECT_NAMES = (
    "capsulemachine",
    "box",
    "ketchup",
    "laptop",
    "microwave",
    "mixer",
    "notebook",
    "espressomachine",
    "waffleiron",
    "scissors",
    "phone",
)

Z_AXIS = (0.0, 0.0, -1.0)


@dataclasses.dataclass
class ObjectBank:
    """Stacked padded tensors for all objects (meters), on one device."""

    v: torch.Tensor  # (O, Vmax, 3)
    mask: torch.Tensor  # (O, Vmax) 1 for real verts
    v_len: torch.Tensor  # (O,)
    v_sub: torch.Tensor  # (O, 600, 3) top 300 + bottom 300
    parts_ids: torch.Tensor  # (O, Vmax) 1 = top, 2 = bottom, 0 = pad
    parts_sub_ids: torch.Tensor  # (O, 600)
    bbox_top: torch.Tensor  # (O, 8, 3)
    bbox_bottom: torch.Tensor  # (O, 8, 3)
    kp_top: torch.Tensor  # (O, 16, 3)
    kp_bottom: torch.Tensor  # (O, 16, 3)
    diameter: torch.Tensor  # (O,)
    f: np.ndarray | None = None  # (O, Fmax, 3) int32 faces, padded (host)
    f_len: np.ndarray | None = None  # (O,) faces per object
    names: tuple = OBJECT_NAMES

    @property
    def num_objects(self) -> int:
        return self.v.shape[0]


def object_forward(
    bank: ObjectBank,
    angles: torch.Tensor,  # (B, 1) or (B,) articulation radian
    global_orient: torch.Tensor,  # (B, 3) axis-angle
    obj_idx: torch.Tensor,  # (B,) indices into the bank
):
    """Pose the objects: top parts get R_global @ R_arti, bottom parts
    R_global only. Returns the ObjectTensors.forward dict."""
    angles = angles.reshape(-1)
    z_axis = torch.tensor(Z_AXIS, dtype=angles.dtype, device=angles.device)
    R_top = axis_angle_to_matrix(global_orient) @ rotate_about_axis(angles, z_axis)
    R_bot = axis_angle_to_matrix(global_orient)
    obj_idx = obj_idx.long()

    def pose(points, R):
        return torch.einsum("bij,bnj->bni", R, points)

    parts = bank.parts_ids[obj_idx]
    parts_sub = bank.parts_sub_ids[obj_idx]
    v = bank.v[obj_idx]
    v_sub = bank.v_sub[obj_idx]
    v_posed = torch.where((parts == 1)[..., None], pose(v, R_top), pose(v, R_bot))
    v_sub_posed = torch.where((parts_sub == 1)[..., None],
                              pose(v_sub, R_top), pose(v_sub, R_bot))
    bbox3d = torch.cat([pose(bank.bbox_top[obj_idx], R_top),
                        pose(bank.bbox_bottom[obj_idx], R_bot)], 1)
    kp3d = torch.cat([pose(bank.kp_top[obj_idx], R_top),
                      pose(bank.kp_bottom[obj_idx], R_bot)], 1)
    return {
        "v": v_posed,
        "mask": bank.mask[obj_idx],
        "v_len": bank.v_len[obj_idx],
        "v_sub": v_sub_posed,
        "parts_ids": parts,
        "parts_sub_ids": parts_sub,
        "bbox3d": bbox3d,
        "kp3d": kp3d,
        "diameter": bank.diameter[obj_idx],
        "rot": global_orient,
        "radian": angles,
    }



def rigid_transform_batch(points: torch.Tensor, R: torch.Tensor,
                          T: torch.Tensor) -> torch.Tensor:
    """p' = R @ p + T. points (B, N, 3), R (B, 3, 3), T (B, 3, 1) -> (B, N, 3)."""
    return torch.einsum("bij,bnj->bni", R, points) + T.transpose(-1, -2)


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack(
        [
            A, -(b * i - c * h), b * f - c * e,
            B, a * i - c * g, -(a * f - c * d),
            C, -(a * h - b * g), a * e - b * d,
        ],
        -1,
    ).reshape(M.shape)
    return adj / det[..., None, None]


def _polar_newton(M: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Orthogonal polar factor of M by the Newton iteration
    X <- (mu X + (mu X)^-T) / 2 with Higham's scaling mu = |det X|^(-1/3)."""
    one_norm = M.abs().sum(-2).amax(-1)  # max column sum
    inf_norm = M.abs().sum(-1).amax(-1)  # max row sum
    norm = torch.sqrt(one_norm * inf_norm)[..., None, None]
    X = M / norm.clamp(min=1e-12)
    for _ in range(iters):
        det = torch.linalg.det(X).abs()
        mu = torch.pow(det.clamp(min=1e-12), -1.0 / 3.0)[..., None, None]
        Xs = mu * X
        X = 0.5 * (Xs + _inv3x3(Xs).transpose(-1, -2))
    return X


def solve_rigid_transform(A: torch.Tensor, B: torch.Tensor):
    """Least-squares rigid fit B ~= R @ A + t.

    A, B: (..., N, 3) corresponding point sets.
    Returns R (..., 3, 3), t (..., 3, 1) with det(R) = +1."""
    cA = A.mean(-2, keepdim=True)
    cB = B.mean(-2, keepdim=True)
    H = torch.einsum("...ni,...nj->...ij", A - cA, B - cB)
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    D = torch.diag_embed(torch.stack(
        [torch.ones_like(det), torch.ones_like(det), det], -1))
    R_svd = V @ D @ Ut
    R_polar = _polar_newton(H.transpose(-1, -2))
    R = torch.where(det[..., None, None] > 0, R_polar, R_svd)
    t = -(R @ cA.transpose(-1, -2)) + cB.transpose(-1, -2)
    return R, t

