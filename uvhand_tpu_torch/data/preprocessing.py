"""Raw ARCTIC preprocessing: world-coordinate GT -> per-view splits.

Port (a numpy/scipy copy) of `uvhand_tpu/data/preprocessing.py`, the
upstream tooling the reference vendors (arctic_tools/src/arctic/
processing.py world->cam->2d per view, preprocess_dataset.py, and split.py's
protocol splits with `sanity_check_splits`): converts raw mocap ground truth
into the `splits/{setup}_{split}.npy` schema that `ArcticDataset` reads.
"""

from __future__ import annotations

import os
import os.path as op
from typing import Dict, List, Sequence

import numpy as np


def world_to_cam(points_w: np.ndarray, w2c: np.ndarray) -> np.ndarray:
    """(N, 3) world points through (..., 4, 4) world->cam matrices
    -> (..., N, 3)."""
    homo = np.concatenate([points_w, np.ones_like(points_w[..., :1])], -1)
    return np.einsum("...ij,nj->...ni", w2c[..., :3, :], homo)


def project(points_cam: np.ndarray, K: np.ndarray) -> np.ndarray:
    uvw = points_cam @ K.T
    return uvw[..., :2] / np.maximum(uvw[..., 2:], 1e-9)


def compute_crop_bbox(kp2d_all: np.ndarray, image_size, pad: float = 1.5):
    """Square crop [cx, cy, scale] covering all entity keypoints
    (scale normalized by 200px, matching the splits schema)."""
    lo = kp2d_all.reshape(-1, 2).min(0)
    hi = kp2d_all.reshape(-1, 2).max(0)
    c = (lo + hi) / 2
    dim = float(max(hi - lo)) * pad
    return np.array([c[0], c[1], max(dim, 1.0) / 200.0], np.float32)


def process_sequence(
    seq_world: Dict[str, np.ndarray],
    world2cam: Sequence[np.ndarray],  # (V-1) fixed rigs, 4x4
    K_fixed: Sequence[np.ndarray],  # (V-1) intrinsics
    ego_w2c: np.ndarray,  # (F, 4, 4) egocentric trajectory
    K_ego: np.ndarray,  # (F, 3, 3)
    params: Dict[str, np.ndarray],
    image_sizes: Sequence[Sequence[int]],
) -> Dict:
    """Raw world GT -> per-view cam/2d/bbox dict (splits `data_dict` entry).

    seq_world keys: joints.right/joints.left (F,21,3), kp3d (F,32,3),
    bbox3d (F,16,3), rot_r/rot_l world axis-angle (F,3).
    """
    F = seq_world["joints.right"].shape[0]
    V = 1 + len(world2cam)
    w2c_all = np.zeros((F, V, 4, 4), np.float64)
    w2c_all[:, 0] = ego_w2c
    for v, m in enumerate(world2cam):
        w2c_all[:, v + 1] = np.asarray(m)

    out_cam: Dict[str, np.ndarray] = {}
    out_2d: Dict[str, np.ndarray] = {}
    for key in ("joints.right", "joints.left", "kp3d", "bbox3d"):
        pts_w = np.asarray(seq_world[key], np.float64)  # (F, N, 3)
        cam = np.stack(
            [world_to_cam(pts_w[f], w2c_all[f]) for f in range(F)], 0
        )  # (F, V, N, 3)
        out_cam[key] = cam.astype(np.float32)
        uv = np.zeros(cam.shape[:-1] + (2,), np.float32)
        for f in range(F):
            uv[f, 0] = project(cam[f, 0], np.asarray(K_ego[f]))
            for v in range(1, V):
                uv[f, v] = project(cam[f, v], np.asarray(K_fixed[v - 1]))
        out_2d[key] = uv

    # global hand rotations per view: R_cam = R_view @ R_world
    from scipy.spatial.transform import Rotation as SR

    for side in ("r", "l"):
        aa_w = np.asarray(seq_world[f"rot_{side}"], np.float64)  # (F, 3)
        Rw = SR.from_rotvec(aa_w).as_matrix()
        rots = np.zeros((F, V, 3), np.float32)
        for f in range(F):
            for v in range(V):
                rots[f, v] = SR.from_matrix(w2c_all[f, v, :3, :3] @ Rw[f]).as_rotvec()
        out_cam[f"rot_{side}_cam"] = rots

    # validity: root + >=3 joints inside the image (arctic_dataset get_valid)
    is_valid = np.ones((F, V), np.float32)
    right_valid = np.zeros((F, V), np.int64)
    left_valid = np.zeros((F, V), np.int64)
    for v in range(V):
        Wv, Hv = image_sizes[v]
        for side, arr in (("right", right_valid), ("left", left_valid)):
            uv = out_2d[f"joints.{side}"][:, v]
            inside = (
                (uv[..., 0] >= 0) & (uv[..., 0] < Wv)
                & (uv[..., 1] >= 0) & (uv[..., 1] < Hv)
            )
            arr[:, v] = (inside[:, 0] & (inside.sum(1) >= 3)).astype(np.int64)
    out_cam["is_valid"] = is_valid
    out_cam["right_valid"] = right_valid
    out_cam["left_valid"] = left_valid

    bbox = np.zeros((F, V, 3), np.float32)
    for f in range(F):
        for v in range(V):
            kps = np.concatenate(
                [out_2d["joints.right"][f, v], out_2d["joints.left"][f, v],
                 out_2d["kp3d"][f, v]], 0,
            )
            bbox[f, v] = compute_crop_bbox(kps, image_sizes[v])

    return {
        "cam_coord": out_cam,
        "2d": out_2d,
        "bbox": bbox,
        "params": dict(params),
    }


# ARCTIC protocol split definitions (split.py:25-192): p1 = allocentric
# (train subjects, val s05, test s06), p2 = egocentric views only.
P1_VAL_SUBJECTS = ("s05",)
P1_TEST_SUBJECTS = ("s06",)


def build_splits(data_dict: Dict[str, Dict], imgnames: List[str], setup: str = "p1"):
    """Partition imgnames into train/val/test by subject; returns dict of
    {split: (data_dict_subset, imgnames)} with disjointness verified."""
    out = {}
    for split in ("train", "val", "test"):
        names = []
        for n in imgnames:
            sid, _, view, _ = n.split("/")[-4:]
            in_val = sid in P1_VAL_SUBJECTS
            in_test = sid in P1_TEST_SUBJECTS
            if setup == "p2" and int(view) != 0:
                continue
            if setup == "p1" and int(view) == 0:
                continue
            if (split == "val" and in_val) or (split == "test" and in_test) or (
                split == "train" and not in_val and not in_test
            ):
                names.append(n)
        keys = {f"{n.split('/')[-4]}/{n.split('/')[-3]}" for n in names}
        sub = {k: v for k, v in data_dict.items() if k in keys}
        out[split] = ({"data_dict": sub, "imgnames": names})
    sanity_check_splits(out)
    return out


def sanity_check_splits(splits: Dict):
    """Disjointness asserts (split.py:101-140)."""
    sets = {k: set(v["imgnames"]) for k, v in splits.items()}
    assert not (sets["train"] & sets["val"]), "train/val overlap"
    assert not (sets["train"] & sets["test"]), "train/test overlap"
    assert not (sets["val"] & sets["test"]), "val/test overlap"


def save_splits(splits: Dict, out_dir: str, setup: str = "p1"):
    os.makedirs(out_dir, exist_ok=True)
    for split, payload in splits.items():
        np.save(op.join(out_dir, f"{setup}_{split}.npy"), payload, allow_pickle=True)
