"""The benchmark's synthetic MANO layers and object bank, as numpy arrays.

The licensed MANO assets and the ARCTIC object meshes are not in the
repository, so both are drawn from fixed seeds with the real structure: a
MANO model whose joints lie on a kinematic chain and whose J_regressor
reproduces them from the template, and a bank of 11 padded objects with top
and bottom parts, keypoints and boxes. The arrays are the same draws as the
port's `geometry.mano.synthetic_mano` and `geometry.objects.
synthetic_object_bank` (copied here so that the benchmark makes its own
inputs). Each side builds its own tensors from them: `mano_fields` and
`bank_fields` give the keyword arguments of a MANO model and an object bank
dataclass, the port's or the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import MANO_PARENTS, NUM_JOINTS, NUM_POSE_FEAT, NUM_SHAPE, NUM_VERTS, OBJECT_NAMES

#: the seeds of the right hand, the left hand and the object bank
MANO_SEEDS = {"right": 0, "left": 1}
BANK_SEED = 2


def synthetic_mano(seed: int) -> dict:
    """A structurally valid MANO model as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    joints = rng.normal(scale=0.03, size=(NUM_JOINTS, 3)).astype(np.float32)
    for j in range(1, NUM_JOINTS):
        joints[j] += joints[MANO_PARENTS[j]]
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
    arrays = dict(
        v_template=v_template,
        shapedirs=rng.normal(scale=0.001, size=(NUM_VERTS, 3, NUM_SHAPE)),
        posedirs=rng.normal(scale=0.0001, size=(NUM_POSE_FEAT, NUM_VERTS * 3)),
        J_regressor=J_reg, lbs_weights=w,
        hands_mean=rng.normal(scale=0.05, size=(45,)))
    return {k: np.asarray(v, np.float32) for k, v in arrays.items()}


def synthetic_object_bank(seed: int = BANK_SEED, num_objects: int = 11,
                          vmax: int = 512) -> dict:
    """A random object bank with the real structure, as numpy arrays."""
    rng = np.random.default_rng(seed)
    v_len = rng.integers(vmax // 2, vmax, size=num_objects)
    v = rng.normal(scale=0.05, size=(num_objects, vmax, 3)).astype(np.float32)
    mask = (np.arange(vmax)[None] < v_len[:, None]).astype(np.float32)
    v *= mask[..., None]
    parts = rng.integers(1, 3, size=(num_objects, vmax)).astype(np.int32)
    parts *= mask.astype(np.int32)
    f32 = lambda x: np.asarray(x, np.float32)
    i32 = lambda x: np.asarray(x, np.int32)
    return dict(
        v=f32(v), mask=f32(mask), v_len=i32(v_len),
        v_sub=f32(rng.normal(scale=0.05, size=(num_objects, 600, 3))),
        parts_ids=i32(parts),
        parts_sub_ids=i32(rng.integers(1, 3, size=(num_objects, 600))),
        bbox_top=f32(rng.normal(scale=0.05, size=(num_objects, 8, 3))),
        bbox_bottom=f32(rng.normal(scale=0.05, size=(num_objects, 8, 3))),
        kp_top=f32(rng.normal(scale=0.05, size=(num_objects, 16, 3))),
        kp_bottom=f32(rng.normal(scale=0.05, size=(num_objects, 16, 3))),
        diameter=f32(np.abs(rng.normal(0.2, 0.05, size=num_objects))))


def mano_fields(arrays: dict, is_rhand: bool, device) -> dict:
    """Keyword arguments of a MANO model dataclass on `device`."""
    out = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
    out.update(faces=np.zeros((1538, 3), np.int32), is_rhand=is_rhand)
    return out


def bank_fields(arrays: dict, device) -> dict:
    """Keyword arguments of an object bank dataclass on `device`."""
    n = arrays["v"].shape[0]
    out = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
    out.update(f=np.zeros((n, 4, 3), np.int32), f_len=np.full(n, 4),
               names=tuple(OBJECT_NAMES[:n]))
    return out
