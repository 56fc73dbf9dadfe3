"""A plain reading of the synthetic ARCTIC root, held against the batches
that the port's data path made from it.

Each batch row is found in the root by its right hand's shape (drawn anew
for every frame) and its 3D joints (the view). The fields it compares:
  - `gt`: the fields that pass through the data path unchanged in either
    split: both hands' shapes, their finger poses (the pose after its
    first three, the global rotation), their 3D joints, the object's 3D
    keypoints (top the first 16) and articulation, the validity flags, the
    labels (object, left hand, right hand), the object's bank index and
    the intrinsics of the crop;
  - `kp2d` (val split only): the 2D fields in the crop, normalised to
    [-1, 1],
  - `image` (val split only): the crop itself, normalised.
The crop is ARCTIC's for its `cropped_images` (upstream
`src/datasets/dataset_utils.py` and `data_utils.py`): the egocentric view
(0) downscaled by 0.3, an allocentric view cropped to 1000 pixels around
its box; the patch of 200 * scale pixels around the centre, blurred
(5 x 5, sigma 8) and warped bicubically to `img_res`, in RGB over 255,
then ImageNet's mean and deviation; a 2D point mapped by the same patch
and truncated to the pixel, as upstream's `transform` does (its
`pt + 1 - 1` kept, since it rounds). The train
split's crop, rotation and colour noise are drawn per row by the data
path, so only its `gt` fields are read here.
"""

from __future__ import annotations

import os.path as op
from typing import Dict, List, Optional, Tuple

import numpy as np

from .geometry import OBJECT_NAMES

#: ARCTIC's class of each object (upstream `common/ld_utils` order), and
#: the classes of the left and the right hand
OBJECT_CLASS = {"box": 1, "capsulemachine": 2, "espressomachine": 3, "ketchup": 4,
                "laptop": 5, "microwave": 6, "mixer": 7, "notebook": 8, "phone": 9,
                "scissors": 10, "waffleiron": 11}
HAND_CLASSES = (12, 13)
EGO_SCALE = 0.3
FOCAL = 1000.0
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def load(path: str, split: str) -> Tuple[dict, dict]:
    """(the split's sequences, misc.json) of the root at `path`."""
    import json

    data = np.load(op.join(path, f"splits/p1_{split}.npy"), allow_pickle=True).item()
    with open(op.join(path, "meta/misc.json")) as f:
        misc = json.load(f)
    return data["data_dict"], misc


def frames_by_shape(seqs: dict) -> Dict[bytes, Tuple[str, int]]:
    """{right-hand shape's bytes: (sequence key, frame)}."""
    out = {}
    for key, seq in seqs.items():
        for f, beta in enumerate(np.asarray(seq["params"]["shape_r"], np.float32)):
            out[beta.tobytes()] = (key, f)
    return out


def find(row: dict, seqs: dict, index: dict) -> Optional[Tuple[str, int, int]]:
    """(sequence key, frame, view) of a batch row, or None. Of the views
    whose 3D joints the row holds, the one whose global rotation the row's
    turns about the camera's axis alone (the train split's in-plane
    rotation; none in the val split)."""
    from scipy.spatial.transform import Rotation

    hit = index.get(np.asarray(row["mano.beta.r"], np.float32).tobytes())
    if hit is None:
        return None
    key, f = hit
    cam = seqs[key]["cam_coord"]
    views = [v for v in range(cam["joints.right"].shape[1])
             if np.array_equal(cam["joints.right"][f, v], row["mano.j3d.full.r"])]
    if not views:
        return None
    turned = Rotation.from_rotvec(np.asarray(row["mano.pose.r"][:3], np.float64)).as_matrix()

    def off_axis(v):
        own = Rotation.from_rotvec(np.asarray(cam["rot_r_cam"][f, v], np.float64)).as_matrix()
        return abs(1.0 - (turned @ own.T)[2, 2])

    return key, f, min(views, key=off_axis)


def intrinsics(seq: dict, misc: dict, sid: str, f: int, v: int, img_res: int) -> np.ndarray:
    """The crop's intrinsics: the egocentric camera's own, fitted to the
    whole image's crop; a fixed focal length for the allocentric views."""
    if v == 0:
        k = np.asarray(seq["params"]["K_ego"][f], np.float32)
        scale = 1.0 * (max(misc[sid]["image_size"][v]) / 200.0)
        fx = k[0, 0] / (200 * scale) * img_res
        fy = k[1, 1] / (200 * scale) * img_res
        return np.array([[fx, 0, img_res // 2], [0, fy, img_res // 2], [0, 0, 1]], np.float32)
    return np.array([[FOCAL, 0, img_res // 2], [0, FOCAL, img_res // 2], [0, 0, 1]], np.float32)


def gt_fields(seq: dict, misc: dict, key: str, f: int, v: int, img_res: int
              ) -> Dict[str, np.ndarray]:
    """The row's fields that the data path passes through unchanged."""
    cam, params = seq["cam_coord"], seq["params"]
    obj = key.split("/")[1].split("_")[0]
    kp3d = np.asarray(cam["kp3d"][f, v], np.float32)
    valid = float(cam["is_valid"][f, v])
    left, right = float(cam["left_valid"][f, v]), float(cam["right_valid"][f, v])
    return {
        "mano.beta.r": params["shape_r"][f], "mano.beta.l": params["shape_l"][f],
        "mano.pose.r[3:]": params["pose_r"][f], "mano.pose.l[3:]": params["pose_l"][f],
        "mano.j3d.full.r": cam["joints.right"][f, v], "mano.j3d.full.l": cam["joints.left"][f, v],
        "object.kp3d.full.t": kp3d[:16], "object.kp3d.full.b": kp3d[16:],
        "object.radian": params["obj_arti"][f],
        "is_valid": valid, "left_valid": left * valid, "right_valid": right * valid,
        "labels": np.array([OBJECT_CLASS[obj], HAND_CLASSES[0] if left else -1,
                            HAND_CLASSES[1] if right else -1]),
        "query_idx": OBJECT_NAMES.index(obj),
        "intrinsics": intrinsics(seq, misc, key.split("/")[0], f, v, img_res),
    }


def crop_box(seq: dict, f: int, v: int) -> Tuple[list, object]:
    """(centre, scale) of the crop in the `cropped_images` frame."""
    box = list(np.array(seq["bbox"][f, v], np.float32))
    if v == 0:
        box = [b * EGO_SCALE for b in box]
    else:
        box = [np.float32(500.0), np.float32(500.0), np.float32(1000.0 / (1.5 * 200))]
    return box[:2], box[2]


def two_d(seq: dict, f: int, v: int, img_res: int) -> Dict[str, np.ndarray]:
    """The 2D fields of the val split's crop, normalised to [-1, 1]."""
    d2 = seq["2d"]
    (cx, cy), scale = crop_box(seq, f, v)
    raw = np.array(seq["bbox"][f, v], np.float32)
    h = 200 * scale
    patch = np.array([[float(img_res) / h, 0.0, img_res * (-float(cx) / h + 0.5)],
                      [0.0, float(img_res) / h, img_res * (-float(cy) / h + 0.5)],
                      [0.0, 0.0, 1.0]])

    def norm(points):
        p = np.array(points, np.float64)
        if v == 0:
            p = p * EGO_SCALE
        else:
            s = 200 * raw[2]
            factor = 1000.0 / (1.5 * s)
            p = np.stack([(p[:, 0] - (raw[0] - 1.5 / 2 * s)) * factor,
                          (p[:, 1] - (raw[1] - 1.5 / 2 * s)) * factor], 1)
        xy = (np.concatenate([p + 1 - 1, np.ones((len(p), 1))], 1) @ patch.T)[:, :2]
        return (2.0 * (xy.astype(int) + 1) / img_res - 1.0).astype(np.float32)

    kp, box3 = norm(d2["kp3d"][f, v]), norm(d2["bbox3d"][f, v])
    return {"mano.j2d.norm.r": norm(d2["joints.right"][f, v]),
            "mano.j2d.norm.l": norm(d2["joints.left"][f, v]),
            "object.kp2d.norm.t": kp[:16], "object.kp2d.norm.b": kp[16:],
            "object.bbox2d.norm.t": box3[:8], "object.bbox2d.norm.b": box3[8:]}


def image(path: str, key: str, seq: dict, f: int, v: int, img_res: int) -> np.ndarray:
    """The val split's crop of the row's JPEG, (img_res, img_res, 3)."""
    import cv2

    sid, name = key.split("/")
    raw = cv2.imread(op.join(path, "cropped_images", sid, name, str(v), f"{f:05d}.jpg"))
    rgb = cv2.cvtColor(raw, cv2.COLOR_BGR2RGB).astype(np.float32)
    (cx, cy), scale = crop_box(seq, f, v)
    side = float(int(1.0 * scale * 200))
    c = np.array([float(cx), float(cy)], np.float32)
    half = np.float32(img_res * 0.5)
    src = np.stack([c, c + np.array([0, side * 0.5], np.float32),
                    c + np.array([side * 0.5, 0], np.float32)])
    dst = np.array([[half, half], [half, 2 * half], [2 * half, half]], np.float32)
    m = cv2.getAffineTransform(np.float32(src), dst).astype(np.float32)
    blur = cv2.GaussianBlur(rgb, (5, 5), 8.0)
    patch = cv2.warpAffine(blur, m, (img_res, img_res), flags=cv2.INTER_CUBIC)
    patch = np.clip(patch.astype(np.float32), 0.0, 255.0).astype(np.float32) / 255.0
    return (patch - MEAN) / STD


def gaps(batches: List[dict], path: str, split: str, img_res: int, image_rows: set
         ) -> Dict[str, float]:
    """The widest |batch - plain reading| of each group of fields over every
    row (`gt`, and in the val split `kp2d`), and of the images over the rows
    `image_rows` ([(batch, row)], val split); a row not found in the root
    reads inf."""
    seqs, misc = load(path, split)
    index = frames_by_shape(seqs)
    out = {"gt": 0.0}
    if split == "val":
        out.update(kp2d=0.0, image=0.0)
    for b, batch in enumerate(batches):
        for r in range(len(batch["images"])):
            row = {k: np.asarray(v[r]) for k, v in batch.items()}
            hit = find(row, seqs, index)
            if hit is None:
                out = {k: float("inf") for k in out}
                continue
            key, f, v = hit
            seq = seqs[key]
            for name, want in gt_fields(seq, misc, key, f, v, img_res).items():
                got = row[name[:-4]][3:] if name.endswith("[3:]") else row[name]
                out["gt"] = max(out["gt"], _gap(got, want))
            if split != "val":
                continue
            for name, want in two_d(seq, f, v, img_res).items():
                out["kp2d"] = max(out["kp2d"], _gap(row[name], want))
            if (b, r) in image_rows:
                out["image"] = max(out["image"], _gap(row["images"],
                                                      image(path, key, seq, f, v, img_res)))
    return out


def _gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max()) if got.size else 0.0
