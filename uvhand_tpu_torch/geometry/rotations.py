"""Rotation representation conversions.

Port of `uvhand_tpu/geometry/rotations.py` (the reference's
pytorch3d-derived `arctic_tools/common/rot.py` and manopth's Rodrigues
layer): quaternion algebra, axis-angle <-> quaternion <-> matrix
(Shepperd's extraction, first argmax among the four candidates as
`jnp.argmax`), Zhou et al.'s 6D representation and Euler angles. Batched
over any leading dimensions, stable at small angles through the same Taylor
fallback (no data-dependent branching).

Conventions: quaternions are (w, x, y, z), w >= 0 after
`standardize_quaternion`; axis-angle vectors are angle * unit_axis in
radians; matrices act on column vectors (p' = R @ p).
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Force the real part to be non-negative (q and -q are the same rotation)."""
    return torch.where(q[..., :1] < 0, -q, q)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = torch.unbind(a, -1)
    bw, bx, by, bz = torch.unbind(b, -1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        -1,
    )


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quaternion_apply(q: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate `point` (..., 3) by quaternion `q` (..., 4)."""
    p = torch.cat([torch.zeros_like(point[..., :1]), point], -1)
    return quaternion_multiply(quaternion_multiply(q, p), quaternion_invert(q))[..., 1:]


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


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a subgradient of 0 at x = 0."""
    positive = x > 0
    safe = torch.where(positive, x, torch.ones_like(x))
    return torch.where(positive, torch.sqrt(safe), torch.zeros_like(x))


def one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Shepperd-style extraction: the best-conditioned of 4 candidates."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.unbind(
        matrix.reshape(matrix.shape[:-2] + (9,)), -1)
    q_abs = _sqrt_positive_part(torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        -1,
    ))
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
        ],
        -2,
    )
    candidates = quat_by_rijk / (2.0 * q_abs[..., None].clamp(min=0.1))
    onehot = one_hot(torch.argmax(q_abs, -1), 4, candidates.dtype)
    return standardize_quaternion((candidates * onehot[..., None]).sum(-2))


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(norms, q[..., :1])
    angles = 2.0 * half
    small = angles.abs() < _EPS
    safe = torch.where(small, torch.ones_like(angles), angles)
    sin_half_over_angle = torch.where(
        small, 0.5 - (angles * angles) / 48.0, torch.sin(half) / safe)
    return q[..., 1:] / sin_half_over_angle


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al. continuous 6D -> rotation matrix (Gram-Schmidt)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp(min=_EPS)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / torch.linalg.norm(a2p, dim=-1, keepdim=True).clamp(min=_EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], -2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def euler_angles_to_matrix(euler: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    def axis_rot(axis: str, angle: torch.Tensor) -> torch.Tensor:
        c, s = torch.cos(angle), torch.sin(angle)
        one, zero = torch.ones_like(angle), torch.zeros_like(angle)
        if axis == "X":
            rows = [one, zero, zero, zero, c, -s, zero, s, c]
        elif axis == "Y":
            rows = [c, zero, s, zero, one, zero, -s, zero, c]
        else:
            rows = [c, -s, zero, s, c, zero, zero, zero, one]
        return torch.stack(rows, -1).reshape(angle.shape + (3, 3))

    mats = [axis_rot(c, euler[..., i]) for i, c in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def rotate_about_axis(radian: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Rotation matrix for `radian` (...,) about a fixed unit `axis` (3,)."""
    return axis_angle_to_matrix(radian[..., None] * axis)
