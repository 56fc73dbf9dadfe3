"""MANO hand model: linear blend skinning.

Port of `uvhand_tpu/geometry/mano.py` (the reference's
`smplx.MANO(use_pca=False, flat_hand_mean=False)`).

Output contract:
  - vertices: (B, 778, 3) meters
  - joints:   (B, 21, 3) meters = 16 kinematic joints followed by the 5
    fingertip vertices [thumb 744, index 320, middle 443, ring 554,
    pinky 672]; joint 0 is the wrist.

`load_mano_pkl` reads the licensed MPI assets; `synthetic_mano` draws a
structurally valid model from a seed with the same numpy stream as the JAX
package, so the two packages build the same model from the same seed.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from .rotations import axis_angle_to_matrix

TIP_VERTEX_IDS = (744, 320, 443, 554, 672)  # thumb, index, middle, ring, pinky

# kinematic parents of the 16 joints (wrist + 3 per finger: index 1-3,
# middle 4-6, pinky 7-9, ring 10-12, thumb 13-15)
MANO_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)

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


def _model(device, faces, is_rhand, **arrays) -> MANOModel:
    dev = resolve_device(device)
    tensors = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
               for k, v in arrays.items()}
    return MANOModel(**tensors, faces=faces, is_rhand=bool(is_rhand))


def _np(x: Any) -> np.ndarray:
    """Materialize chumpy / scipy-sparse / numpy objects from a MANO pkl."""
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    if hasattr(x, "r"):
        return np.asarray(x.r)
    return np.asarray(x)


def load_mano_pkl(path: str, is_rhand: bool | None = None, device=None) -> MANOModel:
    """Load MANO_RIGHT.pkl / MANO_LEFT.pkl (original MPI assets) onto
    `device` (the CUDA card unless `device="cpu"`)."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if is_rhand is None:
        is_rhand = "RIGHT" in path.upper()
    shapedirs = _np(data["shapedirs"]).astype(np.float32)[..., :NUM_SHAPE]
    if not is_rhand and np.sum(np.abs(shapedirs[:, 0, :])) > 0:
        # original MANO_LEFT.pkl shapedirs x-axis bug; smplx applies this fix
        shapedirs = shapedirs.copy()
        shapedirs[:, 0, :] *= -1
    posedirs = _np(data["posedirs"]).astype(np.float32)
    posedirs = posedirs.reshape(NUM_VERTS * 3, NUM_POSE_FEAT).T  # (135, 2334)
    return _model(
        device, np.asarray(_np(data["f"]), np.int32), is_rhand,
        v_template=_np(data["v_template"]), shapedirs=shapedirs,
        posedirs=posedirs, J_regressor=_np(data["J_regressor"]),
        lbs_weights=_np(data["weights"]), hands_mean=_np(data["hands_mean"]))


def synthetic_mano(seed: int = 0, is_rhand: bool = True, device=None) -> MANOModel:
    """Random but structurally valid MANO (the assets are licensed), on
    `device` (the CUDA card unless `device="cpu"`)."""
    rng = np.random.default_rng(seed)
    # joints on a plausible chain so the rigid math is exercised
    joints = rng.normal(scale=0.03, size=(NUM_JOINTS, 3)).astype(np.float32)
    for j in range(1, NUM_JOINTS):
        joints[j] += joints[MANO_PARENTS[j]]
    # vertices scattered near joints; J_regressor is a soft assignment such
    # that J_regressor @ v_template reproduces `joints`
    assign = rng.integers(0, NUM_JOINTS, size=NUM_VERTS)
    v_template = joints[assign] + rng.normal(scale=0.01, size=(NUM_VERTS, 3))
    J_reg = np.zeros((NUM_JOINTS, NUM_VERTS), np.float32)
    for j in range(NUM_JOINTS):
        members = np.where(assign == j)[0]
        J_reg[j, members] = 1.0 / len(members)
    v_template = v_template + (joints - J_reg @ v_template)[assign]
    w = np.zeros((NUM_VERTS, NUM_JOINTS), np.float32)
    w[np.arange(NUM_VERTS), assign] = 0.8
    w[np.arange(NUM_VERTS), np.maximum(np.array(MANO_PARENTS)[assign], 0)] += 0.2
    w /= w.sum(1, keepdims=True)
    return _model(
        device, np.zeros((1538, 3), np.int32), is_rhand,
        v_template=v_template,
        shapedirs=rng.normal(scale=0.001, size=(NUM_VERTS, 3, NUM_SHAPE)),
        posedirs=rng.normal(scale=0.0001, size=(NUM_POSE_FEAT, NUM_VERTS * 3)),
        J_regressor=J_reg, lbs_weights=w,
        hands_mean=rng.normal(scale=0.05, size=(45,)))


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
