"""Articulated ARCTIC object bank.

Port of `uvhand_tpu/geometry/objects.py` (the reference's `ObjectTensors`):
11 rigid two-part objects, articulated by rotating the top part about the
canonical axis [0, 0, -1] by a radian, then rotated globally
(axis-angle). Outputs padded vertices, the 600 subsampled vertices, the
16-corner bbox3d (top 8 + bottom 8) and 32 keypoints (top 16 + bottom 16).
Objects are picked by indexing a stacked, padded bank.

`synthetic_object_bank` draws a structurally identical bank from a seed with
the same numpy stream as the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .rotations import axis_angle_to_matrix, rotate_about_axis

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


def synthetic_object_bank(seed: int = 0, num_objects: int = 11, vmax: int = 512,
                          device=None) -> ObjectBank:
    """Random bank with the real structure, on `device` (the CUDA card
    unless `device="cpu"`)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    v_len = rng.integers(vmax // 2, vmax, size=num_objects)
    v = rng.normal(scale=0.05, size=(num_objects, vmax, 3)).astype(np.float32)
    mask = (np.arange(vmax)[None] < v_len[:, None]).astype(np.float32)
    v *= mask[..., None]
    parts = rng.integers(1, 3, size=(num_objects, vmax)).astype(np.int32)
    parts *= mask.astype(np.int32)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=dev)
    return ObjectBank(
        v=f32(v),
        mask=f32(mask),
        v_len=i32(v_len),
        v_sub=f32(rng.normal(scale=0.05, size=(num_objects, 600, 3))),
        parts_ids=i32(parts),
        parts_sub_ids=i32(rng.integers(1, 3, size=(num_objects, 600))),
        bbox_top=f32(rng.normal(scale=0.05, size=(num_objects, 8, 3))),
        bbox_bottom=f32(rng.normal(scale=0.05, size=(num_objects, 8, 3))),
        kp_top=f32(rng.normal(scale=0.05, size=(num_objects, 16, 3))),
        kp_bottom=f32(rng.normal(scale=0.05, size=(num_objects, 16, 3))),
        diameter=f32(np.abs(rng.normal(0.2, 0.05, size=num_objects))),
        names=tuple(OBJECT_NAMES[:num_objects]),
    )
