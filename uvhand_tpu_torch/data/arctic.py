"""ARCTIC dataset: split loading, cropping/augmentation, static-schema samples.

Port of `uvhand_tpu/data/arctic.py` (the reference's `ArcticDataset`,
`arctic_tools/src/datasets/arctic_dataset.py`, and its speedup crop path,
`dataset_utils.py`), a copy in numpy and cv2:

  - `__getitem__` returns ONE flat dict of fixed-shape numpy arrays -- the
    criterion/process target schema. Labels/keypoints are padded to 3 slots
    (object, left, right) with a validity mask.
  - augmentation (rot 180, scale 0.5, pixel noise 0.4) is driven by a
    per-(seed, index) numpy Generator through the JAX package's calls, so
    a sample equals its sample bit for bit.
  - the UVHand DETR keypoint renormalization (x/840, y->160y/(600*224)+32/224)
    is applied for the 42-d matching targets.

Works against the official ARCTIC file layout; `make_synthetic_root` writes a
miniature structurally-identical dataset (the same files as the JAX
package's for one seed) so the pipeline is testable without the licensed
data. The temporal route's windows are copies too: `create_windows` and
`WindowDataset` (whole non-overlapping windows, for SmoothNet),
`TempoTrainDataset` (a window centred on every frame, for `--method
arctic_lstm`), `collate_tempo_train` and `collate_windows` (B windows of T
frames flattened to B*T rows). The native image path
(`native_images="on"/"fast"`) is not ported (ROADMAP Queue 1 item 4b).
"""

from __future__ import annotations

import json
import os
import os.path as op
from typing import Dict, List, Optional

import numpy as np

from ..geometry.objects import OBJECT_NAMES
from . import augment

# ARCTIC class-label table (reference cfg.py:14-26): 0=bg-ish, 1..11 objects
# (ALPHABETICAL order), 12/13 hands. NOTE this is a DIFFERENT numbering from
# the object-bank index (OBJECT_NAMES == the reference ObjectTensors OBJECTS
# order, used for kp3d_cano / query_idx) — the reference carries both, and
# deriving obj2idx from the bank order mislabels 9 of 11 objects (caught by
# the round-5 data A/B, test_reference_parity_data.py).
OBJ2IDX = {
    "box": 1, "capsulemachine": 2, "espressomachine": 3, "ketchup": 4,
    "laptop": 5, "microwave": 6, "mixer": 7, "notebook": 8, "phone": 9,
    "scissors": 10, "waffleiron": 11,
}
HAND_IDX = (12, 13)  # left, right
NUM_CLASSES = 14
T_SLOTS = 3  # object, left hand, right hand


def transform_kp2d_crop(kp2d, bbox):
    """data_utils.transform_kp2d: full image coords -> cropped image coords."""
    cx, cy, scale = bbox
    s = 200 * scale
    factor = 1000.0 / (1.5 * s)
    out = np.copy(kp2d)
    out[:, 0] = (out[:, 0] - (cx - 1.5 / 2 * s)) * factor
    out[:, 1] = (out[:, 1] - (cy - 1.5 / 2 * s)) * factor
    return out


SUBSET_SIZES = {
    # dataset_utils.py:102-133 (get_num_images) mini/tiny/small split sizes.
    # NOTE the asymmetric test sizes (tinytest 6000, minitest 200) — the
    # round-5 data-layer A/B vs the reference's own downsample caught this
    # table carrying 500/80 (copied from the val row).
    "smalltrain": 100000, "tinytrain": 12000, "minitrain": 300,
    "smallval": 12000, "tinyval": 500, "minival": 80,
    "smalltest": 12000, "tinytest": 6000, "minitest": 200,
}


def downsample(imgnames, split):
    """Deterministic subset for mini/tiny/small splits
    (dataset_utils.py:153-170: random.seed(1) + random.sample).

    The reference draws `random.randint(0, 100)` FIRST and asserts it is 17
    (a same-seed sanity check). That draw advances the RNG stream, so it
    changes which samples `random.sample` picks — replicate it exactly or
    every mini/tiny subset differs from the reference's (caught by the
    round-5 data A/B)."""
    if "small" not in split and "mini" not in split and "tiny" not in split:
        return imgnames
    import random

    rng = random.Random(1)
    assert rng.randint(0, 100) == 17, "RNG stream drifted from reference"
    n = min(SUBSET_SIZES.get(split, len(imgnames)), len(imgnames))
    return rng.sample(imgnames, n)


class ArcticDataset:
    def __init__(
        self,
        root: str,
        setup: str = "p1",
        split: str = "train",
        img_res: int = 224,
        focal_length: float = 1000.0,
        use_gt_k: bool = False,
        speedup: bool = True,
        ego_image_scale: float = 0.3,
        aug: Optional[bool] = None,
        seed: int = 0,
        kp3d_cano: Optional[np.ndarray] = None,  # (O, 16, 3) object bottom kps
        two_stage: bool = True,
        eval_mode: bool = False,  # getitem_eval: images+K only, GT withheld
        seq: Optional[str] = None,  # single-sequence filter (--seq)
        viewpoint: Optional[str] = None,  # "sid/seq/view" filter (--test_viewpoint)
        native_images: str = "off",  # "off" | "on" | "fast": C++ image path
    ):
        self.root = root
        self.img_res = img_res
        self.focal_length = focal_length
        self.use_gt_k = use_gt_k
        self.speedup = speedup
        self.ego_image_scale = ego_image_scale
        self.split = split
        self.aug = split.endswith("train") if aug is None else aug
        self.seed = seed
        self.two_stage = two_stage
        self.eval_mode = eval_mode
        if eval_mode:
            self.aug = False

        short = split.replace("mini", "").replace("tiny", "").replace("small", "")
        data = np.load(
            op.join(root, f"splits/{setup}_{short}.npy"), allow_pickle=True
        ).item()
        self.data = data["data_dict"]
        # ORDER matters: the reference filters by seq BEFORE downsampling
        # (_process_imgnames, arctic_dataset.py:424-430), so a mini/tiny
        # subset under --seq is sampled from the filtered list
        self.imgnames = list(data["imgnames"])
        if seq is not None:
            # single-sequence filter; augmentation off under it
            # (arctic_dataset.py:424-438)
            self.imgnames = [n for n in self.imgnames if "/" + seq + "/" in n]
            self.aug = False
        self.imgnames = downsample(self.imgnames, split)
        if viewpoint is not None:
            # evaluate one (subject, seq, view) only (--test_viewpoint,
            # settings.py:33-35)
            self.imgnames = [n for n in self.imgnames if viewpoint in n]
        with open(op.join(root, "meta/misc.json")) as f:
            misc = json.load(f)
        self.intris_mat = {s: m["intris_mat"] for s, m in misc.items()}
        self.image_sizes = {s: m["image_size"] for s, m in misc.items()}
        self.ioi_offset = {s: m["ioi_offset"] for s, m in misc.items()}
        self.kp3d_cano = kp3d_cano  # meters
        self.egocam_k = None
        # the native (C++) image path of the JAX package is not ported
        if native_images not in ("off", "on", "fast"):
            raise ValueError(f"native_images={native_images!r}")
        if native_images != "off":
            raise NotImplementedError(
                f"native_images={native_images!r}: the native image path is not ported "
                f"(ROADMAP Queue 1 item 4); use 'off'")
        self.native_images = native_images

    def _load_image(self, img_path, center, bbox_dim, augm):
        """Image half of __getitem__: decode + rgb_processing + normalize,
        the reference ops one by one. Returns (img, ok)."""
        import cv2

        cv_img = cv2.imread(img_path)
        if cv_img is None:
            cv_img = np.zeros((600, 840, 3), np.float32)
            ok = False
        else:
            cv_img = cv2.cvtColor(cv_img, cv2.COLOR_BGR2RGB).astype(np.float32)
            ok = True
        img = augment.rgb_processing(cv_img, center, bbox_dim, augm, self.img_res)
        return augment.normalize_image(img), ok

    def __len__(self):
        return len(self.imgnames)

    def _img_path(self, imgname: str) -> str:
        p = imgname
        if self.speedup:
            p = p.replace("/images/", "/cropped_images/")
        # strip the "./arctic_data/data" style prefix down to our root
        parts = p.split("/")
        i = parts.index("cropped_images") if "cropped_images" in parts else parts.index("images")
        return op.join(self.root, *parts[i:])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        imgname = self.imgnames[index]
        rng = np.random.default_rng((self.seed, index))
        sid, seq_name, view_s, image_idx = imgname.split("/")[-4:]
        obj_name = "".join(c for c in seq_name.split("_")[0] if not c.isdigit())
        view_idx = int(view_s)
        seq = self.data[f"{sid}/{seq_name}"]
        vidx = int(image_idx.split(".")[0]) - self.ioi_offset[sid]

        if self.eval_mode:
            # getitem_eval (arctic_dataset.py:487): crop + intrinsics only;
            # GT withheld on the test server
            return self._getitem_eval(imgname, sid, seq_name, view_idx, vidx,
                                      seq["bbox"], seq.get("params", {}))

        cam, d2, bbox_all, params = seq["cam_coord"], seq["2d"], seq["bbox"], seq["params"]

        is_valid = float(cam["is_valid"][vidx, view_idx])
        right_valid = int(cam["right_valid"][vidx, view_idx])
        left_valid = int(cam["left_valid"][vidx, view_idx])

        if view_idx == 0:
            intrx = np.array(params["K_ego"][vidx], np.float32)
        else:
            intrx = np.array(self.intris_mat[sid][view_idx - 1], np.float32)

        j2d_r = augment.pad_jts2d(np.array(d2["joints.right"][vidx, view_idx], np.float64))
        j2d_l = augment.pad_jts2d(np.array(d2["joints.left"][vidx, view_idx], np.float64))
        j3d_r = np.array(cam["joints.right"][vidx, view_idx], np.float32)
        j3d_l = np.array(cam["joints.left"][vidx, view_idx], np.float32)
        pose_r = np.concatenate([cam["rot_r_cam"][vidx, view_idx], params["pose_r"][vidx]]).astype(np.float64)
        pose_l = np.concatenate([cam["rot_l_cam"][vidx, view_idx], params["pose_l"][vidx]]).astype(np.float64)
        beta_r = np.array(params["shape_r"][vidx], np.float32)
        beta_l = np.array(params["shape_l"][vidx], np.float32)

        bbox2d = augment.pad_jts2d(np.array(d2["bbox3d"][vidx, view_idx], np.float64))
        bbox3d = np.array(cam["bbox3d"][vidx, view_idx], np.float32)
        kp2d = augment.pad_jts2d(np.array(d2["kp3d"][vidx, view_idx], np.float64))
        kp3d = np.array(cam["kp3d"][vidx, view_idx], np.float32)
        radian = np.float32(params["obj_arti"][vidx])

        # float32 ON PURPOSE: the reference's bbox rides a float32 array
        # (dataset_utils.py:51 np.array of the float32 annotation), so every
        # derived center/scale is float32-rounded BEFORE the crop transforms.
        # float64 here shifts the affine by ~1e-7, which flips the int
        # truncation in the DETR keypoint renorm on knife-edge values
        # (caught by the round-5 data A/B).
        bbox = list(np.array(bbox_all[vidx, view_idx], np.float32))
        is_egocam = view_idx == 0

        kp2d_t, kp2d_b = kp2d[:16], kp2d[16:]
        bbox2d_t, bbox2d_b = bbox2d[:8], bbox2d[8:]
        kp3d_t, kp3d_b = kp3d[:16], kp3d[16:]

        # speedup crop coordinate change (dataset_utils.py:55-76)
        if self.speedup:
            if is_egocam:
                for a in (j2d_r, j2d_l, kp2d_b, kp2d_t, bbox2d_b, bbox2d_t):
                    a[:, :2] *= self.ego_image_scale
                bbox = [v * self.ego_image_scale for v in bbox]
            else:
                j2d_r = transform_kp2d_crop(j2d_r, bbox)
                j2d_l = transform_kp2d_crop(j2d_l, bbox)
                kp2d_b = transform_kp2d_crop(kp2d_b, bbox)
                kp2d_t = transform_kp2d_crop(kp2d_t, bbox)
                bbox2d_b = transform_kp2d_crop(bbox2d_b, bbox)
                bbox2d_t = transform_kp2d_crop(bbox2d_t, bbox)
                # assigned INTO the float32 array by the reference -> f32
                bbox = [np.float32(500.0), np.float32(500.0),
                        np.float32(1000.0 / (1.5 * 200))]

        center = [bbox[0], bbox[1]]
        scale = bbox[2]

        augm = augment.augm_params(rng, self.aug)
        use_gt_k = self.use_gt_k
        if is_egocam:
            use_gt_k = True
            augm["sc"] = 1.0

        img_path = self._img_path(imgname)
        img, img_ok = self._load_image(img_path, center, scale, augm)
        if not img_ok:
            is_valid = 0.0

        j2d_r = augment.j2d_processing(j2d_r, center, scale, augm, self.img_res)
        j2d_l = augment.j2d_processing(j2d_l, center, scale, augm, self.img_res)
        kp2d_b = augment.j2d_processing(kp2d_b, center, scale, augm, self.img_res)
        kp2d_t = augment.j2d_processing(kp2d_t, center, scale, augm, self.img_res)
        bbox2d_b = augment.j2d_processing(bbox2d_b, center, scale, augm, self.img_res)
        bbox2d_t = augment.j2d_processing(bbox2d_t, center, scale, augm, self.img_res)

        pose_r = augment.pose_processing(pose_r, augm)
        pose_l = augment.pose_processing(pose_l, augm)

        # object canonical rotation via rigid fit + augmentation rotation
        # (arctic_dataset.py:277-290)
        if self.kp3d_cano is not None:
            obj_idx = OBJECT_NAMES.index(obj_name)
            cano = np.asarray(self.kp3d_cano[obj_idx], np.float64)
            R = _kabsch_np(cano, kp3d_b.astype(np.float64))
            import cv2 as _cv2

            aa, _ = _cv2.Rodrigues(R)
            obj_rot = augment.rot_aa(aa[:, 0], augm["rot"])
            query_idx = obj_idx
        else:
            obj_rot = np.zeros(3, np.float32)
            query_idx = 0

        sc_orig = max(self.image_sizes[sid][view_idx]) / 200.0
        c_orig = [s / 2.0 for s in self.image_sizes[sid][view_idx]]
        K = augment.get_aug_intrinsics(
            intrx, self.focal_length, self.img_res, use_gt_k,
            c_orig[0], c_orig[1], augm["sc"] * sc_orig,
        )
        if is_egocam:
            if self.egocam_k is None:
                self.egocam_k = K
            else:
                K = self.egocam_k

        # DETR matching targets (3 padded slots: object, left, right)
        labels = np.full(T_SLOTS, -1, np.int32)
        keypoints = np.zeros((T_SLOTS, 42), np.float32)
        tvalid = np.zeros(T_SLOTS, bool)
        labels[0] = OBJ2IDX[obj_name]
        tvalid[0] = True
        if self.two_stage:
            small_obj_idx = [i for i in range(32) if i % 3 != 0]
            obj_kps = np.concatenate([kp2d_t, kp2d_b], 0)[small_obj_idx, :2][:21]
            keypoints[0] = augment.renormalize_keypoints_for_detr(
                obj_kps, center, augm["sc"] * scale, self.img_res
            ).reshape(42)
        if left_valid:
            labels[1] = HAND_IDX[0]
            tvalid[1] = True
            if self.two_stage:
                keypoints[1] = augment.renormalize_keypoints_for_detr(
                    j2d_l[:, :2], center, augm["sc"] * scale, self.img_res
                ).reshape(42)
        if right_valid:
            labels[2] = HAND_IDX[1]
            tvalid[2] = True
            if self.two_stage:
                keypoints[2] = augment.renormalize_keypoints_for_detr(
                    j2d_r[:, :2], center, augm["sc"] * scale, self.img_res
                ).reshape(42)

        return {
            "images": img.astype(np.float32),
            "labels": labels,
            "keypoints": keypoints,
            "target_valid": tvalid,
            "is_valid": np.float32(is_valid),
            "left_valid": np.float32(left_valid * is_valid),
            "right_valid": np.float32(right_valid * is_valid),
            "joints_valid_r": np.full(21, right_valid * is_valid, np.float32),
            "joints_valid_l": np.full(21, left_valid * is_valid, np.float32),
            "mano.pose.r": pose_r.astype(np.float32),
            "mano.pose.l": pose_l.astype(np.float32),
            "mano.beta.r": beta_r,
            "mano.beta.l": beta_l,
            "mano.j2d.norm.r": j2d_r[:, :2],
            "mano.j2d.norm.l": j2d_l[:, :2],
            "mano.j3d.full.r": j3d_r,
            "mano.j3d.full.l": j3d_l,
            "object.kp2d.norm.t": kp2d_t[:, :2],
            "object.kp2d.norm.b": kp2d_b[:, :2],
            "object.bbox2d.norm.t": bbox2d_t[:, :2],
            "object.bbox2d.norm.b": bbox2d_b[:, :2],
            "object.kp3d.full.b": kp3d_b,
            "object.kp3d.full.t": kp3d_t,
            "object.radian": radian,
            "object.rot": obj_rot.astype(np.float32),
            "intrinsics": K.astype(np.float32),
            "query_idx": np.int32(query_idx),
            "imgname": imgname,
        }


    def _getitem_eval(self, imgname, sid, seq_name, view_idx, vidx, bbox_all, params):
        is_egocam = view_idx == 0
        if view_idx == 0 and "K_ego" in params:
            intrx = np.array(params["K_ego"][vidx], np.float32)
        elif view_idx > 0:
            intrx = np.array(self.intris_mat[sid][view_idx - 1], np.float32)
        else:
            intrx = np.eye(3, dtype=np.float32)

        # float32 like the reference's bbox array (see __getitem__ note)
        bbox = list(np.array(bbox_all[vidx, view_idx], np.float32))
        if self.speedup:
            if is_egocam:
                bbox = [v * self.ego_image_scale for v in bbox]
            else:
                bbox = [np.float32(500.0), np.float32(500.0),
                        np.float32(1000.0 / (1.5 * 200))]
        center, scale = [bbox[0], bbox[1]], bbox[2]

        augm = augment.augm_params(np.random.default_rng(0), False)
        img, _ = self._load_image(self._img_path(imgname), center, scale, augm)
        sc_orig = max(self.image_sizes[sid][view_idx]) / 200.0
        c_orig = [s / 2.0 for s in self.image_sizes[sid][view_idx]]
        K = augment.get_aug_intrinsics(
            intrx, self.focal_length, self.img_res, is_egocam,
            c_orig[0], c_orig[1], sc_orig,
        )
        obj_name = "".join(c for c in seq_name.split("_")[0] if not c.isdigit())
        return {
            "images": img.astype(np.float32),
            "intrinsics": K.astype(np.float32),
            "query_idx": np.int32(OBJECT_NAMES.index(obj_name)),
            "imgname": imgname,
        }


def _kabsch_np(A, B):
    """R such that B ~= R @ A (solve_rigid_tf_np, transforms.py:128)."""
    cA, cB = A.mean(0), B.mean(0)
    H = (A - cA).T @ (B - cB)
    U, S, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        Vt = Vt.copy()
        Vt[2] *= -1
        R = Vt.T @ U.T
    return R


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack static-shape samples into batch arrays (drops string keys)."""
    out = {}
    for k in samples[0]:
        if k == "imgname":
            continue
        out[k] = np.stack([s[k] for s in samples], 0)
    return out


def create_windows(imgnames: List[str], window_size: int) -> List[List[str]]:
    """Group per (subject, seq, view), chunk into non-overlapping windows,
    pad the last window with its final element
    (tempo_inference_dataset.py:15-42)."""
    groups: Dict[str, List[str]] = {}
    for n in imgnames:
        sid, seq, view, _ = n.split("/")[-4:]
        groups.setdefault(f"{sid}/{seq}/{view}", []).append(n)
    windows = []
    for key in groups:
        names = sorted(groups[key])
        for i in range(0, len(names), window_size):
            w = names[i: i + window_size]
            while len(w) < window_size:
                w.append(w[-1])
            windows.append(w)
    return windows


def _stack_window(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """T samples -> one window item: every array stacked on a new leading
    axis (T, ...), the image names kept as a list."""
    out = {}
    for k in samples[0]:
        if k == "imgname":
            out["imgname"] = [s["imgname"] for s in samples]
            continue
        out[k] = np.stack([s[k] for s in samples], 0)
    return out


class WindowDataset:
    """Temporal windows over an ArcticDataset (TempoInferenceDataset
    equivalent, tempo_inference_dataset.py:45-182): each item is a stacked
    window of `window_size` consecutive frames from one (subject, seq, view);
    `collate_windows` flattens B windows x T frames into a B*T leading axis
    (factory.py:56-116 collate_custom_fn)."""

    def __init__(self, base: "ArcticDataset", window_size: int):
        self.base = base
        self.window_size = window_size
        self.windows = create_windows(base.imgnames, window_size)
        self._name_to_idx = {n: i for i, n in enumerate(base.imgnames)}

    def __len__(self):
        return len(self.windows)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return _stack_window([self.base[self._name_to_idx[n]] for n in self.windows[index]])


class TempoTrainDataset:
    """Training windows centred per frame (`TempoDataset`,
    arctic_tools/src/datasets/tempo_dataset.py:57-103): one item per frame;
    the window indices are `arange(T) - (T-1)/2 + frame`, truncated toward
    zero, clipped to `[10, n-10-1]` because the first/last 10 frames of each
    ARCTIC sequence "are not useful" (:69-71). `center_pos` (int32) is the
    window slot nearest the clipped frame, so the collate can keep the
    centre frame's targets (`split_window=False`) without ragged shapes.
    Sequences shorter than 21 frames (test fixtures) degrade to the widest
    valid clip range."""

    CLIP = 10

    def __init__(self, base: "ArcticDataset", window_size: int, split_window: bool = True):
        self.base = base
        self.window_size = window_size
        self.split_window = split_window
        groups: Dict[str, List[str]] = {}
        for n in base.imgnames:
            sid, seq, view, _ = n.split("/")[-4:]
            groups.setdefault(f"{sid}/{seq}/{view}", []).append(n)
        self.groups = {k: sorted(v) for k, v in groups.items()}
        self.items = [(k, i) for k, v in self.groups.items() for i in range(len(v))]
        self._name_to_idx = {n: i for i, n in enumerate(base.imgnames)}

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        key, pos = self.items[index]
        names = self.groups[key]
        n, T = len(names), self.window_size
        lo = min(self.CLIP, max((n - 1) // 2, 0))
        hi = max(n - self.CLIP - 1, lo)
        ind = np.clip((np.arange(T) - (T - 1) / 2 + pos).astype(np.int64), lo, hi)
        out = _stack_window([self.base[self._name_to_idx[names[i]]] for i in ind])
        out["center_pos"] = np.int32(np.argmin(np.abs(ind - np.clip(pos, lo, hi))))
        return out


def collate_tempo_train(samples: List[Dict[str, np.ndarray]],
                        split_window: bool = True) -> Dict[str, np.ndarray]:
    """Window-train collate (`collate_custom_fn`, factory.py:56-116): images
    always flatten (B, T) -> B*T for the frame-parallel model; the other
    arrays stay per frame with `split_window`, else only each window's
    centre frame is kept, and `center_index` gives its row in the flattened
    batch (read by `engine.select_output_frames`)."""
    B = len(samples)
    T = samples[0]["images"].shape[0]
    centers = np.array([int(s["center_pos"]) for s in samples], np.int32)
    out = {}
    for k in samples[0]:
        if k in ("imgname", "center_pos"):
            continue
        stacked = np.stack([s[k] for s in samples], 0)  # (B, T, ...)
        if k == "images" or split_window:
            out[k] = stacked.reshape((-1,) + stacked.shape[2:])
        else:
            out[k] = stacked[np.arange(B), centers]
    if not split_window:
        out["center_index"] = np.arange(B, dtype=np.int32) * T + centers
    return out


def collate_windows(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """(B windows, T, ...) -> (B*T, ...) leading axis (drops the names)."""
    out = {}
    for k in samples[0]:
        if k == "imgname":
            continue
        stacked = np.stack([s[k] for s in samples], 0)  # (B, T, ...)
        out[k] = stacked.reshape((-1,) + stacked.shape[2:])
    return out


def make_synthetic_root(path: str, num_seqs: int = 2, frames: int = 6, views: int = 2,
                        seed: int = 0, image_hw=(600, 840), obj_bank=None,
                        render_gt: bool = False) -> None:
    """Write a miniature ARCTIC-layout dataset for pipeline tests.

    With `obj_bank` (a geometry.objects.ObjectBank, on any device), the object GT is
    SELF-CONSISTENT with that bank: per-frame kp3d/bbox3d are the bank's
    canonical keypoints posed by a sampled (radian, rotation, translation)
    — exactly what `process_targets` inverts (Kabsch rigid fit + LSQ
    camera-translation solve). Without it (default, kept for existing
    fixtures) those fields are independent random clouds; the GT solves
    then return large, ill-conditioned translations (~1e2) and the camera
    loss terms dominate the criterion at ~1e6 scale — harmless for
    throughput benches, fatal for optimization studies. Use the bank for
    anything that trains more than a few steps on this data.

    With `render_gt=True` the projected 2D GT is DRAWN into each image
    (per-joint color-coded discs for both hands and the object keypoints),
    so an image -> pose mapping actually exists and a model trained on one
    root can be scored on a HELD-OUT root (different seed) through the real
    metric stack. Default off: the noise-image fixtures stay byte-pinned.
    """
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(op.join(path, "splits"), exist_ok=True)
    os.makedirs(op.join(path, "meta"), exist_ok=True)

    sid = "s01"
    misc = {
        sid: {
            "intris_mat": [
                [[1000.0, 0, 420], [0, 1000.0, 300], [0, 0, 1]]
                for _ in range(max(views - 1, 1))
            ],
            "world2cam": [np.eye(4).tolist() for _ in range(max(views - 1, 1))],
            "image_size": [[840, 600] for _ in range(views)],
            "ioi_offset": 0,
        }
    }
    with open(op.join(path, "meta/misc.json"), "w") as f:
        json.dump(misc, f)

    data_dict = {}
    imgnames = []
    H, W = image_hw
    for s in range(num_seqs):
        obj = OBJECT_NAMES[s % len(OBJECT_NAMES)]
        seq_name = f"{obj}_use_{s:02d}"
        F, V = frames, views
        mk = lambda *shape: rng.normal(size=shape).astype(np.float32)
        jr_3d = mk(F, V, 21, 3) * 0.1 + np.array([0, 0, 0.6], np.float32)
        jl_3d = mk(F, V, 21, 3) * 0.1 + np.array([0, 0, 0.6], np.float32)
        obj_arti = np.abs(mk(F)) * 0.5
        if obj_bank is None:
            bb_3d = mk(F, V, 16, 3) * 0.1 + np.array([0, 0, 0.6], np.float32)
            kp_3d = mk(F, V, 32, 3) * 0.1 + np.array([0, 0, 0.6], np.float32)
        else:
            # pose the bank's canonical object: top gets R_glob @ R_arti(z),
            # bottom R_glob only (object_forward semantics), plus a bounded
            # translation in front of the camera
            from scipy.spatial.transform import Rotation as _R

            oidx = list(obj_bank.names).index(obj)
            rot_aa = mk(F, 3) * 0.3
            transl = (mk(F, 3) * np.array([0.08, 0.08, 0.05], np.float32)
                      + np.array([0, 0, 0.6], np.float32))
            Rg = _R.from_rotvec(rot_aa).as_matrix().astype(np.float32)
            # rotate_about_axis(angle, z=[0,0,-1]) == rotvec(-angle * z_hat)
            Ra = _R.from_rotvec(
                obj_arti[:, None] * np.array([0.0, 0.0, -1.0])
            ).as_matrix().astype(np.float32)
            kt, kb, bt, bb = (np.asarray(t[oidx].cpu(), np.float32) for t in (
                obj_bank.kp_top, obj_bank.kp_bottom, obj_bank.bbox_top, obj_bank.bbox_bottom))
            top_R = np.einsum("fij,fjk->fik", Rg, Ra)
            pose_pts = lambda R, pts: (
                np.einsum("fij,nj->fni", R, pts) + transl[:, None]
            ).astype(np.float32)
            kp_3d = np.concatenate([pose_pts(top_R, kt), pose_pts(Rg, kb)], 1)
            bb_3d = np.concatenate([pose_pts(top_R, bt), pose_pts(Rg, bb)], 1)
            kp_3d = np.repeat(kp_3d[:, None], V, axis=1)
            bb_3d = np.repeat(bb_3d[:, None], V, axis=1)
            # hands near the object so relative-translation terms stay small
            jr_3d = (mk(F, 1, 21, 3) * 0.05 + transl[:, None, None, :]
                     ).repeat(V, 1).astype(np.float32)
            jl_3d = (mk(F, 1, 21, 3) * 0.05 + transl[:, None, None, :]
                     ).repeat(V, 1).astype(np.float32)

        def project(p3d):
            # 2D keypoints are real projections of the 3D GT (view 0 uses the
            # ego K, others the rig K — matching the loader's selection) so
            # the dataset's camera fits are well-posed, like real ARCTIC data
            out = np.zeros(p3d.shape[:-1] + (2,), np.float32)
            for v in range(V):
                f_ = 600.0 if v == 0 else 1000.0
                c = np.array([420.0, 300.0])
                xy = p3d[:, v, :, :2] / p3d[:, v, :, 2:3]
                out[:, v] = (xy * f_ + c).astype(np.float32)
            return out

        data_dict[f"{sid}/{seq_name}"] = {
            "cam_coord": {
                "joints.right": jr_3d,
                "joints.left": jl_3d,
                "bbox3d": bb_3d,
                "kp3d": kp_3d,
                "rot_r_cam": mk(F, V, 3) * 0.3,
                "rot_l_cam": mk(F, V, 3) * 0.3,
                "is_valid": np.ones((F, V), np.float32),
                "right_valid": np.ones((F, V), np.int64),
                "left_valid": np.ones((F, V), np.int64),
            },
            "2d": {
                "joints.right": project(jr_3d),
                "joints.left": project(jl_3d),
                "bbox3d": project(bb_3d),
                "kp3d": project(kp_3d),
            },
            "bbox": np.concatenate(
                [
                    rng.uniform(250, 350, size=(F, V, 2)),
                    rng.uniform(1.2, 1.6, size=(F, V, 1)),
                ],
                axis=2,
            ).astype(np.float32),
            "params": {
                "K_ego": np.tile(np.array([[600.0, 0, 420], [0, 600.0, 300], [0, 0, 1]], np.float32), (F, 1, 1)),
                "pose_r": mk(F, 45) * 0.2,
                "pose_l": mk(F, 45) * 0.2,
                "shape_r": mk(F, 10) * 0.5,
                "shape_l": mk(F, 10) * 0.5,
                "dist": mk(F, 8) * 0.01,
                "obj_arti": obj_arti,
            },
        }
        two_d = data_dict[f"{sid}/{seq_name}"]["2d"]
        for v in range(V):
            for fidx in range(F):
                name = f"./arctic_data/data/images/{sid}/{seq_name}/{v}/{fidx:05d}.jpg"
                imgnames.append(name)
                d = op.join(path, "cropped_images", sid, seq_name, str(v))
                os.makedirs(d, exist_ok=True)
                if render_gt:
                    # low-contrast noise floor + per-joint color-coded discs
                    # at the projected GT (learnable localization signal)
                    img = (rng.uniform(90, 160, size=(H, W, 3))).astype(np.uint8)
                    for off, key in ((0, "joints.right"), (64, "joints.left"),
                                     (128, "kp3d")):
                        pts = two_d[key][fidx, v]
                        for j, (x, y) in enumerate(pts):
                            if not (0 <= x < W and 0 <= y < H):
                                continue
                            c = (int((37 * (j + off)) % 256),
                                 int((91 * (j + off) + 60) % 256),
                                 int((151 * (j + off) + 120) % 256))
                            cv2.circle(img, (int(x), int(y)), 4, c, -1)
                else:
                    img = (rng.uniform(0, 255, size=(H, W, 3))).astype(np.uint8)
                cv2.imwrite(op.join(d, f"{fidx:05d}.jpg"), img)

    for split in ("train", "val"):
        np.save(
            op.join(path, f"splits/p1_{split}.npy"),
            {"data_dict": data_dict, "imgnames": imgnames},
            allow_pickle=True,
        )
