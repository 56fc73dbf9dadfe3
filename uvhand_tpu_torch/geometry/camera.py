"""Camera utilities: weak-perspective <-> perspective, 2D projection,
keypoint normalization, the translation solve and the rig/pose helpers.

Port of `uvhand_tpu/geometry/camera.py` (the reference's
`arctic_tools/common/camera.py`: `weak_perspective_to_perspective_torch`,
`perspective_to_weak_perspective_torch`, `project2d_batch`,
`normalize_kp2d`, `estimate_translation_np`, `get_default_cam_t`,
`look_at`, `to_sphere`, `sample_pose_on_sphere`, `rectify_pose`,
`get_coord_maps`, `get_wp_intrix`). Batched over leading dimensions;
`sample_pose_on_sphere` draws from an explicit `torch.Generator` (or takes
its uniforms) where the reference uses numpy's global state.
"""

from __future__ import annotations

import math

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


def get_default_cam_t(focal_length, img_res) -> torch.Tensor:
    """The default camera translation: weak-perspective [s=5, 0, 0]
    converted (the reference's camera.py:74)."""
    return perspective_from_weak(torch.tensor([[5.0, 0.0, 0.0]]), focal_length, img_res)


def perspective_from_weak(wp_cam: torch.Tensor, focal_length, img_res) -> torch.Tensor:
    """`convert_weak_perspective_to_perspective`: no min_s clamp; [tx, ty,
    tz] from wp [s, tx, ty]."""
    tz = 2.0 * focal_length / (img_res * wp_cam[..., 0] + 1e-9)
    return torch.stack([wp_cam[..., 1], wp_cam[..., 2], tz], -1)


def estimate_translation(S: torch.Tensor, joints_2d: torch.Tensor, joints_conf: torch.Tensor,
                         focal_length, img_size) -> torch.Tensor:
    """Confidence-weighted linear solve for the camera translation that
    projects S (..., N, 3) onto joints_2d (..., N, 2) pixels
    (`estimate_translation_np`). Each joint j and axis a gives
    f_a (S_ja + t_a) = (p_ja - c_a)(S_jz + t_z), linear in t; the 2N rows,
    weighted by sqrt(conf), are solved through their 3x3 normal equations.
    focal_length (fx, fy), img_size (H, W)."""
    f = torch.as_tensor(focal_length, dtype=S.dtype, device=S.device)
    center = torch.tensor([img_size[1] / 2.0, img_size[0] / 2.0], dtype=S.dtype,
                          device=S.device)
    Z, XY = S[..., 2:], S[..., :2]
    w = torch.sqrt(joints_conf.clamp(min=0.0))[..., None]
    p_min_c = joints_2d - center
    zeros = torch.zeros_like(Z[..., 0])
    Qx = torch.stack([f[0].expand(zeros.shape), zeros, -p_min_c[..., 0]], -1)
    Qy = torch.stack([zeros, f[1].expand(zeros.shape), -p_min_c[..., 1]], -1)
    Q = torch.stack([Qx, Qy], -2) * w[..., None]  # (..., N, 2, 3)
    rhs = (p_min_c * Z - f * XY) * w  # (..., N, 2)
    Qf = Q.reshape(*Q.shape[:-3], -1, 3)
    rf = rhs.reshape(*rhs.shape[:-2], -1)
    A = torch.einsum("...ri,...rj->...ij", Qf, Qf)
    b = torch.einsum("...ri,...r->...i", Qf, rf)
    return torch.linalg.solve(A, b[..., None])[..., 0]


def look_at(eye, at=None, up=None, eps: float = 1e-5) -> torch.Tensor:
    """Camera rotation whose -z looks from `eye` toward `at`: eye (..., 3)
    -> (..., 3, 3) with columns [x_axis, y_axis, z_axis]."""
    eye = torch.as_tensor(eye, dtype=torch.float32)
    at = torch.zeros(3) if at is None else torch.as_tensor(at, dtype=torch.float32)
    up = torch.tensor([0.0, 0.0, 1.0]) if up is None else torch.as_tensor(up, dtype=torch.float32)
    at, up = at.to(eye.device), up.to(eye.device)

    def norm(v):
        return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=eps)

    z_axis = norm(eye - at)
    x_axis = norm(torch.linalg.cross(up.expand(z_axis.shape), z_axis, dim=-1))
    y_axis = norm(torch.linalg.cross(z_axis, x_axis, dim=-1))
    return torch.stack([x_axis, y_axis, z_axis], -1)


def to_sphere(u, v) -> torch.Tensor:
    """(u, v) in [0, 1]^2 -> a uniform point on the unit sphere."""
    u, v = torch.as_tensor(u, dtype=torch.float32), torch.as_tensor(v, dtype=torch.float32)
    theta = 2.0 * math.pi * u
    phi = torch.arccos(1.0 - 2.0 * v)
    return torch.stack([torch.sin(phi) * torch.cos(theta), torch.sin(phi) * torch.sin(theta),
                        torch.cos(phi)], -1)


def sample_pose_on_sphere(generator: torch.Generator | None = None, range_u=(0.0, 1.0),
                          range_v=(0.0, 1.0), radius=1.0, up=(0.0, 1.0, 0.0),
                          uniforms=None) -> torch.Tensor:
    """A random camera-to-world [R | t] (3, 4) on a sphere around the
    origin. The three uniforms in [0, 1) (u, v, and the radius's where
    `radius` is a (min, max) tuple) are drawn from `generator`, or given as
    `uniforms`; each is scaled to its range as `jax.random.uniform` does."""
    if uniforms is None:
        uniforms = torch.rand(3, generator=generator)
    uniforms = torch.as_tensor(uniforms, dtype=torch.float32)

    def scaled(x, lo_hi):
        return lo_hi[0] + x * (lo_hi[1] - lo_hi[0])

    u, v = scaled(uniforms[0], range_u), scaled(uniforms[1], range_v)
    if isinstance(radius, tuple):
        radius = scaled(uniforms[2], radius)
    loc = to_sphere(u, v) * radius
    R = look_at(loc, up=torch.tensor(up, dtype=torch.float32))
    return torch.cat([R, loc.reshape(3, 1)], 1)


def rectify_pose(camera_r: torch.Tensor, body_aa: torch.Tensor,
                 rotate_x: bool = False) -> torch.Tensor:
    """Compose a camera rotation into a global-orient axis-angle."""
    from .rotations import axis_angle_to_matrix, matrix_to_axis_angle

    body_r = axis_angle_to_matrix(body_aa)
    if rotate_x:
        flip = torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]],
                            dtype=body_r.dtype, device=body_r.device)
        body_r = body_r @ flip
    return matrix_to_axis_angle(camera_r @ body_r)


def get_coord_maps(size: int = 56) -> torch.Tensor:
    """CoordConv-style (x, y) channel maps in [-1, 1], (1, 2, size, size)."""
    r = torch.arange(size, dtype=torch.float32) / (size - 1) * 2.0 - 1.0
    return torch.stack([r[None, :].expand(size, size), r[:, None].expand(size, size)])[None]


def weak_perspective_intrinsics(focal_length: float, img_res: int) -> torch.Tensor:
    """The fixed patch intrinsics of the reference (`get_wp_intrix`)."""
    c = img_res // 2
    return torch.tensor([[focal_length, 0.0, c], [0.0, focal_length, c], [0.0, 0.0, 1.0]],
                        dtype=torch.float32)
