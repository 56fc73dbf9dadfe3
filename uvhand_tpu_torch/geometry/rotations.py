"""Rotation conversions needed by the MANO and object forward passes.

Port of the part of `uvhand_tpu/geometry/rotations.py` that
`mano_forward` / `object_forward` reach: axis-angle -> quaternion ->
matrix, and the fixed-axis rotation. Batched over any leading dimensions,
stable at small angles through the same Taylor fallback (no data-dependent
branching).

Conventions: quaternions are (w, x, y, z); axis-angle vectors are
angle * unit_axis in radians; matrices act on column vectors (p' = R @ p).
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    r, i, j, k = torch.unbind(q, -1)
    two_s = 2.0 / torch.sum(q * q, -1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        -1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    angles = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = angles * 0.5
    small = angles.abs() < _EPS
    # sin(x/2)/x, with Taylor 0.5 - x^2/48 near zero
    safe = torch.where(small, torch.ones_like(angles), angles)
    sin_half_over_angle = torch.where(
        small, 0.5 - (angles * angles) / 48.0, torch.sin(half) / safe)
    return torch.cat([torch.cos(half), axis_angle * sin_half_over_angle], -1)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def rotate_about_axis(radian: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Rotation matrix for `radian` (...,) about a fixed unit `axis` (3,)."""
    return axis_angle_to_matrix(radian[..., None] * axis)
