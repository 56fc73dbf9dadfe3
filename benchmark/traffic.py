"""Traffic: a synthetic ARCTIC root made from the seed, and the batches that
the port's data path reads from it.

A traffic file (`traffic/<name>.json`) holds:
  - `loop`: "train" (`engine.train_one_epoch` over `make_fused_train_step`)
    or "eval" (`engine.evaluate` over `make_eval_step`),
  - `batch`: frames a step or batch; `batches`: distinct batches made at
    set-up and cycled through the window; `split`: "train" (with the
    data path's augmentation) or "val",
  - `root`: the synthetic root (`seqs` sequences x `frames` frames x
    `views` views of `image_hw` JPEGs; `batches * batch` images, so that
    no two rows of the set-up's batches are one frame),
  - `check_steps`: the train steps that the reference follows (train), and
    `trace_steps`: the steps or batches run under the profiler.

`make_root` is the port's `data/arctic.py::make_synthetic_root` copied (the
object GT consistent with the bank, hands beside the object, the 2D GT
the projections of the 3D GT), with smooth images in place of pixel noise
so that a JPEG is tens of kB. `make_batches` reads the root through the
port's `ArcticDataset` and `DataLoader` at set-up; the window then cycles
those batches through the engine's loop and `device_prefetch`, so the
JPEG decode is not in it.
"""

from __future__ import annotations

import json
import os
import os.path as op
from typing import Dict, List

import numpy as np

from .reference.geometry import OBJECT_NAMES


def make_root(path: str, spec: dict, bank: dict, seed: int) -> None:
    """Write the synthetic root of traffic `spec["root"]` under `path`."""
    import cv2
    from scipy.spatial.transform import Rotation

    root = spec["root"]
    num_seqs, F, V = root["seqs"], root["frames"], root["views"]
    H, W = root["image_hw"]
    rng = np.random.default_rng(seed)
    os.makedirs(op.join(path, "splits"), exist_ok=True)
    os.makedirs(op.join(path, "meta"), exist_ok=True)
    sid = "s01"
    misc = {sid: {"intris_mat": [[[1000.0, 0, 420], [0, 1000.0, 300], [0, 0, 1]]
                                 for _ in range(max(V - 1, 1))],
                  "world2cam": [np.eye(4).tolist() for _ in range(max(V - 1, 1))],
                  "image_size": [[W, H] for _ in range(V)], "ioi_offset": 0}}
    with open(op.join(path, "meta/misc.json"), "w") as f:
        json.dump(misc, f)

    data_dict, imgnames = {}, []
    for s in range(num_seqs):
        obj = OBJECT_NAMES[s % len(OBJECT_NAMES)]
        seq_name = f"{obj}_use_{s:02d}"
        mk = lambda *shape: rng.normal(size=shape).astype(np.float32)
        obj_arti = np.abs(mk(F)) * 0.5
        # the bank's canonical object posed: top R_glob @ R_arti(z), bottom
        # R_glob, plus a translation in front of the camera
        oidx = OBJECT_NAMES.index(obj)
        rot_aa = mk(F, 3) * 0.3
        transl = mk(F, 3) * np.array([0.08, 0.08, 0.05], np.float32) + np.array([0, 0, 0.6],
                                                                                np.float32)
        Rg = Rotation.from_rotvec(rot_aa).as_matrix().astype(np.float32)
        Ra = Rotation.from_rotvec(obj_arti[:, None] * np.array([0.0, 0.0, -1.0])
                                  ).as_matrix().astype(np.float32)
        kt, kb, bt, bb = (bank[k][oidx] for k in ("kp_top", "kp_bottom", "bbox_top",
                                                  "bbox_bottom"))
        top_R = np.einsum("fij,fjk->fik", Rg, Ra)

        def pose_pts(R, pts):
            return (np.einsum("fij,nj->fni", R, pts) + transl[:, None]).astype(np.float32)

        kp_3d = np.repeat(np.concatenate([pose_pts(top_R, kt), pose_pts(Rg, kb)], 1)[:, None],
                          V, axis=1)
        bb_3d = np.repeat(np.concatenate([pose_pts(top_R, bt), pose_pts(Rg, bb)], 1)[:, None],
                          V, axis=1)
        jr_3d = (mk(F, 1, 21, 3) * 0.05 + transl[:, None, None, :]).repeat(V, 1)
        jl_3d = (mk(F, 1, 21, 3) * 0.05 + transl[:, None, None, :]).repeat(V, 1)

        def project(p3d):
            out = np.zeros(p3d.shape[:-1] + (2,), np.float32)
            for v in range(V):
                f_ = 600.0 if v == 0 else 1000.0
                xy = p3d[:, v, :, :2] / p3d[:, v, :, 2:3]
                out[:, v] = (xy * f_ + np.array([420.0, 300.0])).astype(np.float32)
            return out

        data_dict[f"{sid}/{seq_name}"] = {
            "cam_coord": {
                "joints.right": jr_3d.astype(np.float32), "joints.left": jl_3d.astype(np.float32),
                "bbox3d": bb_3d, "kp3d": kp_3d,
                "rot_r_cam": mk(F, V, 3) * 0.3, "rot_l_cam": mk(F, V, 3) * 0.3,
                "is_valid": np.ones((F, V), np.float32),
                "right_valid": np.ones((F, V), np.int64),
                "left_valid": np.ones((F, V), np.int64),
            },
            "2d": {"joints.right": project(jr_3d), "joints.left": project(jl_3d),
                   "bbox3d": project(bb_3d), "kp3d": project(kp_3d)},
            "bbox": np.concatenate([rng.uniform(250, 350, size=(F, V, 2)),
                                    rng.uniform(1.2, 1.6, size=(F, V, 1))], 2).astype(np.float32),
            "params": {
                "K_ego": np.tile(np.array([[600.0, 0, 420], [0, 600.0, 300], [0, 0, 1]],
                                          np.float32), (F, 1, 1)),
                "pose_r": mk(F, 45) * 0.2, "pose_l": mk(F, 45) * 0.2,
                "shape_r": mk(F, 10) * 0.5, "shape_l": mk(F, 10) * 0.5,
                "dist": mk(F, 8) * 0.01, "obj_arti": obj_arti,
            },
        }
        for v in range(V):
            d = op.join(path, "cropped_images", sid, seq_name, str(v))
            os.makedirs(d, exist_ok=True)
            for fidx in range(F):
                imgnames.append(f"./arctic_data/data/images/{sid}/{seq_name}/{v}/{fidx:05d}.jpg")
                # smooth colour noise: a coarse grid of random colours, upscaled
                coarse = rng.uniform(0, 255, size=(H // 24 + 1, W // 24 + 1, 3)).astype(np.uint8)
                img = cv2.resize(coarse, (W, H), interpolation=cv2.INTER_LINEAR)
                cv2.imwrite(op.join(d, f"{fidx:05d}.jpg"), img)
    for split in ("train", "val"):
        np.save(op.join(path, f"splits/p1_{split}.npy"),
                {"data_dict": data_dict, "imgnames": imgnames}, allow_pickle=True)


def make_batches(path: str, spec: dict, bank: dict, img_res: int, seed: int
                 ) -> List[Dict[str, np.ndarray]]:
    """`spec["batches"]` batches of `spec["batch"]` frames read from the
    root through the port's `ArcticDataset` (`spec["split"]`, augmented in
    the train split) and `DataLoader` (shuffled from the seed)."""
    from uvhand_tpu_torch.data.arctic import ArcticDataset
    from uvhand_tpu_torch.data.loader import DataLoader

    ds = ArcticDataset(path, "p1", spec["split"], img_res=img_res, seed=seed % (1 << 32),
                       kp3d_cano=bank["kp_bottom"])
    loader = DataLoader(ds, spec["batch"], shuffle=True, seed=seed % (1 << 32))
    try:
        batches = []
        for batch in loader:
            batches.append(batch)
            if len(batches) == spec["batches"]:
                break
    finally:
        loader.close()
    if len(batches) < spec["batches"]:
        raise ValueError(f"the root holds {len(batches)} batches, the traffic asks for "
                         f"{spec['batches']}")
    return batches


def check_batches(batches, spec: dict, img_res: int) -> None:
    """Every batch has `batch` rows and images of `img_res` x `img_res`;
    raises otherwise (the data path sets the work the window does)."""
    for batch in batches:
        b = spec["batch"]
        if batch["images"].shape != (b, img_res, img_res, 3):
            raise ValueError(f"images {batch['images'].shape}, expected ({b}, {img_res}, "
                             f"{img_res}, 3)")
        short = [k for k, v in batch.items() if np.shape(v)[:1] != (b,)]
        if short:
            raise ValueError(f"keys without {b} rows: {short}")
