"""Host-side image/keypoint augmentation (numpy + cv2 workers).

A copy of `uvhand_tpu/data/augment.py` (the reference's
`arctic_tools/common/data_utils.py`: `get_transform`, `transform`,
`gen_trans_from_patch_cv`, `generate_patch_image`, `augm_params`,
`rgb_processing`, `j2d_processing`, `pose_processing`, `rot_aa`). The
crop-geometry helpers are kept line-faithful: they are the numerical
contract (bit-exact crop geometry). The augmentation draws come from a
passed-in numpy Generator through the same calls in the same order, so a
sample is equal bit for bit to the JAX package's for one (seed, index).

These run in host loader workers; nothing here touches torch.
"""

from __future__ import annotations

import cv2
import numpy as np

# ARCTIC hardcoded augmentation constants (arctic_dataset.py:155-161)
NOISE_FACTOR = 0.4
ROT_FACTOR = 180.0
SCALE_FACTOR = 0.5


def get_transform(center, scale, res, rot=0):
    h = 200 * scale
    t = np.zeros((3, 3))
    t[0, 0] = float(res[1]) / h
    t[1, 1] = float(res[0]) / h
    t[0, 2] = res[1] * (-float(center[0]) / h + 0.5)
    t[1, 2] = res[0] * (-float(center[1]) / h + 0.5)
    t[2, 2] = 1
    if rot != 0:
        rot = -rot
        rot_mat = np.zeros((3, 3))
        rot_rad = rot * np.pi / 180
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        rot_mat[2, 2] = 1
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[1] / 2
        t_mat[1, 2] = -res[0] / 2
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = t_inv @ rot_mat @ t_mat @ t
    return t


def transform_point(pt, center, scale, res, invert=0, rot=0):
    t = get_transform(center, scale, res, rot=rot)
    if invert:
        t = np.linalg.inv(t)
    new_pt = np.array([pt[0] - 1, pt[1] - 1, 1.0]).T
    new_pt = t @ new_pt
    return new_pt[:2].astype(int) + 1


def _rotate_2d(pt, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array([pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs], np.float32)


def gen_trans_from_patch_cv(c_x, c_y, src_w, src_h, dst_w, dst_h, scale, rot, inv=False):
    src_w = src_w * scale
    src_h = src_h * scale
    src_center = np.array([c_x, c_y], np.float32)
    rot_rad = np.pi * rot / 180
    src_down = _rotate_2d(np.array([0, src_h * 0.5], np.float32), rot_rad)
    src_right = _rotate_2d(np.array([src_w * 0.5, 0], np.float32), rot_rad)
    dst_center = np.array([dst_w * 0.5, dst_h * 0.5], np.float32)
    src = np.stack([src_center, src_center + src_down, src_center + src_right])
    dst = np.stack(
        [dst_center, dst_center + np.array([0, dst_h * 0.5], np.float32),
         dst_center + np.array([dst_w * 0.5, 0], np.float32)]
    )
    if inv:
        return cv2.getAffineTransform(np.float32(dst), np.float32(src)).astype(np.float32)
    return cv2.getAffineTransform(np.float32(src), np.float32(dst)).astype(np.float32)


def generate_patch_image(img, bbox, scale, rot, out_shape, interp=cv2.INTER_CUBIC,
                         gauss_kernel=5, gauss_sigma=8.0):
    trans = gen_trans_from_patch_cv(
        float(bbox[0]), float(bbox[1]), float(bbox[2]), float(bbox[3]),
        out_shape[1], out_shape[0], scale, rot,
    )
    blur = cv2.GaussianBlur(img, (gauss_kernel, gauss_kernel), gauss_sigma)
    patch = cv2.warpAffine(blur, trans, (int(out_shape[1]), int(out_shape[0])), flags=interp)
    return patch.astype(np.float32), trans


def augm_params(rng: np.random.Generator, is_train: bool, flip_prob: float = 0.0,
                noise_factor: float = NOISE_FACTOR, rot_factor: float = ROT_FACTOR,
                scale_factor: float = SCALE_FACTOR) -> dict:
    flip, pn, rot, sc = 0, np.ones(3), 0.0, 1.0
    if is_train:
        if rng.uniform() <= flip_prob:
            raise NotImplementedError("flipping not supported (reference asserts)")
        pn = rng.uniform(1 - noise_factor, 1 + noise_factor, 3)
        rot = min(2 * rot_factor, max(-2 * rot_factor, rng.standard_normal() * rot_factor))
        sc = min(1 + scale_factor, max(1 - scale_factor, rng.standard_normal() * scale_factor + 1))
        if rng.uniform() <= 0.2:
            rot = 0.0
    return {"flip": flip, "pn": pn, "rot": rot, "sc": sc}


def rgb_processing(rgb_img, center, bbox_dim, augm_dict, img_res):
    """Crop + rotate + pixel noise -> (H, W, 3) float in [0,1] (NHWC!)."""
    scale = augm_dict["sc"] * bbox_dim
    crop_dim = int(scale * 200)
    patch, _ = generate_patch_image(
        rgb_img, [center[0], center[1], crop_dim, crop_dim], 1.0,
        augm_dict["rot"], [img_res, img_res],
    )
    pn = augm_dict["pn"]
    patch = np.clip(patch * pn[None, None, :3], 0.0, 255.0)
    return patch.astype(np.float32) / 255.0


def normalize_image(img01, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)):
    return (img01 - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def j2d_processing(kp, center, bbox_dim, augm_dict, img_res):
    """kp (N, 3) homogeneous-padded pixel coords -> normalized [-1,1]*... .

    Vectorized: ONE affine build + one matmul for all keypoints (the
    per-point loop recomputed the 3x3 transform N times and cost ~8 ms/frame
    on the loader's host path — data_utils.py:162's semantics preserved,
    including the int truncation of transformed points)."""
    scale = augm_dict["sc"] * bbox_dim
    rot = augm_dict["rot"]
    t = get_transform(center, scale, [img_res, img_res], rot=rot)
    kp = kp.copy()
    pts = np.concatenate(
        [kp[:, 0:2] + 1 - 1, np.ones((kp.shape[0], 1))], axis=1
    )  # (pt + 1) - 1, as transform_point does
    new = (pts @ t.T)[:, :2]
    kp[:, 0:2] = new.astype(int) + 1
    kp[:, :2] = 2.0 * kp[:, :2] / img_res - 1.0
    return kp.astype(np.float32)


def rot_aa(aa, rot_deg):
    """Rotate global axis-angle by an in-plane rotation (data_utils.py:257)."""
    R = np.array(
        [
            [np.cos(np.deg2rad(-rot_deg)), -np.sin(np.deg2rad(-rot_deg)), 0],
            [np.sin(np.deg2rad(-rot_deg)), np.cos(np.deg2rad(-rot_deg)), 0],
            [0, 0, 1],
        ]
    )
    per_rdg, _ = cv2.Rodrigues(np.asarray(aa, np.float64))
    resrot, _ = cv2.Rodrigues(R @ per_rdg)
    return resrot.T[0].astype(np.float32)


def pose_processing(pose, augm_dict):
    pose = pose.copy()
    pose[:3] = rot_aa(pose[:3], augm_dict["rot"])
    return pose.astype(np.float32)


def get_aug_intrinsics(intrx, focal_length, img_res, use_gt_k, c_x, c_y, scale):
    """get_aug_intrix (data_utils.py:340): fixed weak-persp K, or gt K scaled
    into the crop patch."""
    if not use_gt_k:
        K = np.zeros((3, 3), np.float32)
        K[0, 0] = K[1, 1] = focal_length
        K[2, 2] = 1.0
        K[0, 2] = K[1, 2] = img_res // 2
        return K
    K = np.asarray(intrx, np.float32).copy()
    # fit the full-image K into the augmented crop (reference `scale` path)
    fx = K[0, 0] / (200 * scale) * img_res
    fy = K[1, 1] / (200 * scale) * img_res
    out = np.array(
        [[fx, 0, img_res // 2], [0, fy, img_res // 2], [0, 0, 1]], np.float32
    )
    return out


def pad_jts2d(jts: np.ndarray) -> np.ndarray:
    """(N, 2) -> (N, 3) homogeneous-confidence pad (dataset_utils.pad_jts2d)."""
    num = jts.shape[0]
    return np.concatenate([jts, np.ones((num, 1), dtype=jts.dtype)], axis=1)


# UVHand keypoint re-normalization constants (arctic_dataset.py:384-395):
# DETR target keypoints are mapped back to the ORIGINAL cropped-image frame
# then renormalized x/840, y -> 160*y/(600*224) + 32/224.
def renormalize_keypoints_for_detr(kp2d_norm, center, scale_aug, img_res):
    """kp2d_norm (N, 2) in [-1,1] patch coords -> UVHand 42-d target space.

    The reference runs this chain on float32 TORCH tensors
    (arctic_dataset.py:343-395: `.float()` targets -> unormalize_kp2d ->
    per-point `transform(..., invert=1)` with its `.astype(int) + 1`
    truncation). The unnormalize/-1 steps are therefore float32 before the
    float64 affine solve; keeping them float64 here flips the int truncation
    on knife-edge values (~±1 px -> 1/840 drift, caught by the data A/B)."""
    kp = (np.float32(0.5) * np.float32(img_res)
          * (kp2d_norm.astype(np.float32) + np.float32(1.0)))
    out = np.zeros_like(kp)
    t = get_transform(center, scale_aug, [img_res, img_res], rot=0)
    t_inv = np.linalg.inv(t)
    one = np.float32(1.0)
    for i in range(kp.shape[0]):
        xy = t_inv @ np.array([kp[i, 0] - one, kp[i, 1] - one, 1.0])
        x, y = (xy[:2].astype(int) + 1).astype(np.float32)
        out[i, 0] = x / 840.0
        out[i, 1] = 160.0 * y / (600.0 * 224.0) + 32.0 / 224.0
    return out.astype(np.float32)
