"""Articulated ARCTIC object bank.

Port of `uvhand_tpu/geometry/objects.py` (the reference's `ObjectTensors`):
11 rigid two-part objects, articulated by rotating the top part about the
canonical axis [0, 0, -1] by a radian, then rotated globally
(axis-angle). Outputs padded vertices, the 600 subsampled vertices, the
16-corner bbox3d (top 8 + bottom 8) and 32 keypoints (top 16 + bottom 16).
Objects are picked by indexing a stacked, padded bank.

`load_object_bank` reads the official ARCTIC `object_vtemplates` layout, and
`synthetic_object_bank` draws a structurally identical bank from a seed with
the same numpy stream as the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os.path as op

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


def object_template(bank: ObjectBank, obj_idx: torch.Tensor):
    """The un-posed template tensors (the reference's forward_template)."""
    obj_idx = obj_idx.long()
    return {
        "v": bank.v[obj_idx],
        "mask": bank.mask[obj_idx],
        "v_len": bank.v_len[obj_idx],
        "v_sub": bank.v_sub[obj_idx],
        "parts_ids": bank.parts_ids[obj_idx],
        "parts_sub_ids": bank.parts_sub_ids[obj_idx],
        "diameter": bank.diameter[obj_idx],
    }


def _pad_stack(arrs, pad_to=None):
    lens = np.array([len(a) for a in arrs])
    m = int(pad_to or lens.max())
    out = np.zeros((len(arrs), m) + arrs[0].shape[1:], arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[i, : len(a)] = a
    return out, lens


def load_object_bank(meta_dir: str, names=OBJECT_NAMES, device=None) -> ObjectBank:
    """Load the official ARCTIC `object_vtemplates` + `object_meta.json`
    onto `device` (the CUDA card unless `device="cpu"`).

    As the JAX package's `load_object_bank` (the reference's
    construct_obj/construct_obj_tensors): mm -> meters (/1000), parts ids
    offset +1, the 300-keypoint subsets matched to their nearest mesh vertex
    for part labels; the faces (fan-triangulated) stay on the host, padded,
    in `f` / `f_len`."""
    dev = resolve_device(device)
    vs, subs, parts_l, parts_sub_l, fs = [], [], [], [], []
    bb_t, bb_b, kp_t, kp_b, diam = [], [], [], [], []
    with open(op.join(meta_dir, "object_meta.json")) as fh:
        meta = json.load(fh)
    for name in names:
        d = op.join(meta_dir, "object_vtemplates", name)
        verts, faces = _load_obj_mesh(op.join(d, "mesh.obj"))
        with open(op.join(d, "parts.json")) as fh:
            parts = np.array(json.load(fh), bool)
        with open(op.join(d, "top_keypoints_300.json")) as fh:
            sub_top = np.array(json.load(fh)["keypoints"])
        with open(op.join(d, "bottom_keypoints_300.json")) as fh:
            sub_bottom = np.array(json.load(fh)["keypoints"])
        sub_v = np.concatenate([sub_top, sub_bottom], 0)
        d2 = ((sub_v[:, None] - verts[None]) ** 2).sum(-1)
        parts_sub = parts[np.argmin(d2, 1)]
        with open(op.join(d, "object_params.json")) as fh:
            params = json.load(fh)
        obj_key = "".join(c for c in name if not c.isdigit())
        vs.append(verts.astype(np.float32) / 1000)
        subs.append(sub_v.astype(np.float32) / 1000)
        fs.append(np.asarray(faces, np.int32))
        parts_l.append(parts.astype(np.int32) + 1)
        parts_sub_l.append(parts_sub.astype(np.int32) + 1)
        bb_t.append(np.array(params["bbox_top"], np.float32) / 1000)
        bb_b.append(np.array(params["bbox_bottom"], np.float32) / 1000)
        kp_t.append(np.array(params["keypoints_top"], np.float32) / 1000)
        kp_b.append(np.array(params["keypoints_bottom"], np.float32) / 1000)
        diam.append(np.float32(meta[obj_key]["diameter"]))
    v, v_len = _pad_stack(vs)
    p, _ = _pad_stack(parts_l, pad_to=v.shape[1])
    f, f_len = _pad_stack(fs)
    mask = (np.arange(v.shape[1])[None] < v_len[:, None]).astype(np.float32)
    t = lambda x, dtype: torch.as_tensor(np.asarray(x, dtype), device=dev)
    return ObjectBank(
        v=t(v, np.float32),
        mask=t(mask, np.float32),
        v_len=t(v_len, np.int32),
        v_sub=t(np.stack(subs), np.float32),
        parts_ids=t(p, np.int32),
        parts_sub_ids=t(np.stack(parts_sub_l), np.int32),
        bbox_top=t(np.stack(bb_t), np.float32),
        bbox_bottom=t(np.stack(bb_b), np.float32),
        kp_top=t(np.stack(kp_t), np.float32),
        kp_bottom=t(np.stack(kp_b), np.float32),
        diameter=t(np.stack(diam), np.float32),
        f=f,
        f_len=f_len,
        names=tuple(names),
    )


def _load_obj_mesh(path: str):
    """Minimal wavefront OBJ reader: vertices (float64) and triangle faces
    (int64; polygons fan-triangulated)."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


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
        f=np.zeros((num_objects, 4, 3), np.int32),
        f_len=np.full(num_objects, 4),
        names=tuple(OBJECT_NAMES[:num_objects]),
    )
