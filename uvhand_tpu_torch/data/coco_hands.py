"""COCO-format hand-keypoint datasets (H2O / FPHA / AssemblyHands).

Port of `uvhand_tpu/data/coco_hands.py` (the reference's
`datasets/coco.py`: `CocoDetection` + `ConvertCocoPolysToMask` with the
`cam2pixel` uvd conversion, and the resize / normalize transforms), numpy
and cv2 on the host, sample for sample the JAX package's: static-shape
samples for the 2.5D model (`models/assembly.py`), u and v normalised to
[0, 1] by the image size, d the depth relative to the root joint; three
slots (left hand, right hand, object). Train augmentation (`aug`: colour
jitter, then a rotation of up to 45 degrees about the centre with the
keypoints) draws from `np.random.default_rng(seed)` in the JAX package's
order; `cache_mode` keeps each decoded, resized image in memory.

Plain json (no pycocotools); `make_synthetic_coco_root` writes the same
layout with random images and keypoints, for tests and the card's smoke
run.
"""

from __future__ import annotations

import json
import os
import os.path as op
from typing import Dict, List

import numpy as np

T_SLOTS = 3  # left hand, right hand, object


def color_jitter(img: np.ndarray, rng, brightness: float = 0.5,
                 contrast: float = 0.5) -> np.ndarray:
    """Train-time jitter (datasets/transforms.py:316-322 `CollorJitter` with
    b=c=0.5, s=h=0): brightness scales pixels, contrast blends with the
    gray mean; factors ~ U(1-x, 1+x). img float32 in [0, 1]."""
    bf = rng.uniform(1 - brightness, 1 + brightness)
    img = np.clip(img * bf, 0.0, 1.0)
    cf = rng.uniform(1 - contrast, 1 + contrast)
    mean = float(img.mean())
    return np.clip((img - mean) * cf + mean, 0.0, 1.0)


def random_rotation(img: np.ndarray, kps_px: np.ndarray, rng,
                    degrees: float = 45.0):
    """Target-aware rotation (datasets/transforms.py:324-372
    `RandomRotation(45)`): warpAffine about the image center, keypoint
    (u, v) columns rotated with the same matrix; extra columns untouched."""
    import cv2

    h, w = img.shape[:2]
    ang = float(rng.uniform(-degrees, degrees))
    rot = cv2.getRotationMatrix2D((w / 2, h / 2), ang, 1.0)
    img = cv2.warpAffine(img, rot, (w, h))
    ones = np.ones((*kps_px.shape[:-1], 1), np.float32)
    pts = np.concatenate([kps_px[..., :2], ones], -1)
    uv = pts @ rot.T.astype(np.float32)
    return img, np.concatenate([uv, kps_px[..., 2:]], -1)


def cam2pixel(cam_coord: np.ndarray, f, c) -> np.ndarray:
    """(N, 3) camera coords -> (u px, v px, z) (datasets/coco.py:53-58)."""
    x = cam_coord[:, 0] / (cam_coord[:, 2] + 1e-8) * f[0] + c[0]
    y = cam_coord[:, 1] / (cam_coord[:, 2] + 1e-8) * f[1] + c[1]
    return np.stack([x, y, cam_coord[:, 2]], 1)


class CocoHandsDataset:
    def __init__(self, root: str, split: str = "train", img_res: int = 224,
                 num_obj_classes: int = 8, aug: bool = False, seed: int = 0,
                 cache_mode: bool = False):
        self.root = root
        self.img_res = img_res
        self.num_obj_classes = num_obj_classes
        # train transforms: ColorJitter + RandomRotation(45)
        # (datasets/coco.py:254-266 applies them for image_set == 'train')
        self.aug = aug
        self.rng = np.random.default_rng(seed)
        # --cache_mode: keep decoded+resized images in memory
        # (CocoDetection cache_mode, datasets/torchvision_datasets/coco.py)
        self.cache_mode = cache_mode
        self._img_cache = {}
        with open(op.join(root, f"annotations/{split}.json")) as f:
            data = json.load(f)
        self.images = {im["id"]: im for im in data["images"]}
        self.anns: Dict[int, List[dict]] = {}
        for a in data["annotations"]:
            self.anns.setdefault(a["image_id"], []).append(a)
        self.ids = sorted(self.images.keys())

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        import cv2

        iid = self.ids[index]
        im_info = self.images[iid]
        if self.cache_mode and iid in self._img_cache:
            img, (H0, W0) = self._img_cache[iid]
            img = img.copy()
        else:
            img = cv2.imread(op.join(self.root, "images", im_info["file_name"]))
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
            H0, W0 = img.shape[:2]
            img = cv2.resize(img, (self.img_res, self.img_res),
                             interpolation=cv2.INTER_LINEAR)
            if self.cache_mode:
                self._img_cache[iid] = (img.copy(), (H0, W0))

        f = im_info["cam_param"]["focal"]
        c = im_info["cam_param"]["princpt"]

        labels = np.full(T_SLOTS, -1, np.int32)
        keys_uvz = np.zeros((T_SLOTS, 21, 3), np.float32)  # u,v in resized px
        keys_rootz = np.zeros(T_SLOTS, np.float32)
        valid = np.zeros(T_SLOTS, bool)
        slot = {"left": 0, "right": 1, "object": 2}
        left_cls = self.num_obj_classes + 1
        right_cls = self.num_obj_classes + 2
        for a in self.anns.get(iid, []):
            kind = a["category"]  # 'left' | 'right' | 'object'
            cam_kp = np.asarray(a["keypoints_cam"], np.float32).reshape(-1, 3)
            uvz = cam2pixel(cam_kp, f, c)
            si = slot[kind]
            labels[si] = (
                left_cls if kind == "left" else right_cls if kind == "right" else a.get("obj_class", 1)
            )
            n = min(21, uvz.shape[0])
            keys_uvz[si, :n, 0] = uvz[:n, 0] * self.img_res / W0
            keys_uvz[si, :n, 1] = uvz[:n, 1] * self.img_res / H0
            keys_uvz[si, :n, 2] = uvz[:n, 2]
            keys_rootz[si] = uvz[0, 2]
            valid[si] = True

        if self.aug:
            # reference order: Resize -> ColorJitter -> RandomRotation ->
            # Normalize (datasets/coco.py:260-266); keypoints rotate in
            # resized pixel space with the image
            img = color_jitter(img, self.rng)
            img, keys_uvz = random_rotation(img, keys_uvz, self.rng, 45.0)

        img = (img - np.array([0.485, 0.456, 0.406], np.float32)) / np.array(
            [0.229, 0.224, 0.225], np.float32
        )

        keys = np.zeros((T_SLOTS, 63), np.float32)
        for si in range(T_SLOTS):
            if valid[si]:
                uvd = np.stack(
                    [keys_uvz[si, :, 0] / self.img_res,
                     keys_uvz[si, :, 1] / self.img_res,
                     keys_uvz[si, :, 2] - keys_rootz[si]], 1)
                keys[si] = uvd.reshape(-1)

        return {
            "images": img.astype(np.float32),
            "labels": labels,
            "keypoints63": keys,
            "target_valid": valid,
        }


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Samples -> a batch: each key's arrays stacked."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def make_synthetic_coco_root(path: str, n_images: int = 6, seed: int = 0,
                             image_hw=(480, 640)):
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(op.join(path, "annotations"), exist_ok=True)
    os.makedirs(op.join(path, "images"), exist_ok=True)
    H, W = image_hw
    images, annotations = [], []
    aid = 0
    for i in range(n_images):
        fn = f"{i:05d}.jpg"
        cv2.imwrite(op.join(path, "images", fn),
                    rng.uniform(0, 255, (H, W, 3)).astype(np.uint8))
        images.append({
            "id": i, "file_name": fn, "width": W, "height": H,
            "cam_param": {"focal": [600.0, 600.0], "princpt": [W / 2, H / 2]},
        })
        for kind in ("left", "right", "object"):
            kp = rng.normal(size=(21, 3)).astype(float) * 0.05 + [0, 0, 0.5]
            annotations.append({
                "id": aid, "image_id": i, "category": kind,
                "keypoints_cam": kp.reshape(-1).tolist(),
                "bbox": [10, 10, 100, 100], "obj_class": int(rng.integers(1, 8)),
            })
            aid += 1
    for split in ("train", "val"):
        with open(op.join(path, f"annotations/{split}.json"), "w") as fh:
            json.dump({"images": images, "annotations": annotations}, fh)
