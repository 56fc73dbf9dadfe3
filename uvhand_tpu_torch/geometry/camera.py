"""Camera helpers of the serving path: weak-perspective <-> perspective,
2D projection and keypoint normalization.

Port of the matching functions of `uvhand_tpu/geometry/camera.py` (the
reference's `weak_perspective_to_perspective_torch`,
`perspective_to_weak_perspective_torch`, `project2d_batch`,
`normalize_kp2d`).
"""

from __future__ import annotations

import torch


def weak_perspective_to_perspective(wp_cam: torch.Tensor, focal_length, img_res,
                                    min_s: float = 0.1) -> torch.Tensor:
    """wp_cam (..., 3) = [s, tx, ty] -> camera translation [tx, ty, tz]."""
    s = wp_cam[..., 0].clamp(min=min_s)
    tz = 2.0 * focal_length / (img_res * s + 1e-9)
    return torch.stack([wp_cam[..., 1], wp_cam[..., 2], tz], -1)


def perspective_to_weak_perspective(cam_t: torch.Tensor, focal_length,
                                    img_res) -> torch.Tensor:
    """cam_t (..., 3) = [tx, ty, tz] -> weak-perspective [s, tx, ty]."""
    s = 2.0 * focal_length / (img_res * cam_t[..., 2] + 1e-9)
    return torch.stack([s, cam_t[..., 0], cam_t[..., 1]], -1)


def project2d(K: torch.Tensor, pts_cam: torch.Tensor) -> torch.Tensor:
    """K (..., 3, 3), pts_cam (..., N, 3) -> pixel coords (..., N, 2)."""
    homo = torch.einsum("...ij,...nj->...ni", K, pts_cam)
    return homo[..., :2] / homo[..., 2:].clamp(min=1e-9)


def normalize_kp2d(kp2d: torch.Tensor, img_res) -> torch.Tensor:
    """Pixel coords -> [-1, 1] (reference convention 2*p/res - 1)."""
    return 2.0 * kp2d / img_res - 1.0


def unnormalize_kp2d(kp2d_norm: torch.Tensor, img_res) -> torch.Tensor:
    return 0.5 * img_res * (kp2d_norm + 1.0)
