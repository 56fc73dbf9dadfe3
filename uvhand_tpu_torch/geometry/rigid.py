"""Batched rigid alignment (Kabsch / Arun) and rigid transforms.

Port of `uvhand_tpu/geometry/rigid.py` (`to_homo` and `transform_points`
too). The rotation is the orthogonal
polar factor of H^T, polished by Newton iteration, whenever det(V U^T) > 0;
the SVD form with the reflection fix covers the rest, as in the JAX solver.
Callers on the card run it in full float32 (TF32 off).
"""

from __future__ import annotations

import torch


def rigid_transform_batch(points: torch.Tensor, R: torch.Tensor,
                          T: torch.Tensor) -> torch.Tensor:
    """p' = R @ p + T. points (B, N, 3), R (B, 3, 3), T (B, 3, 1) -> (B, N, 3)."""
    return torch.einsum("bij,bnj->bni", R, points) + T.transpose(-1, -2)


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack(
        [
            A, -(b * i - c * h), b * f - c * e,
            B, a * i - c * g, -(a * f - c * d),
            C, -(a * h - b * g), a * e - b * d,
        ],
        -1,
    ).reshape(M.shape)
    return adj / det[..., None, None]


def _polar_newton(M: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Orthogonal polar factor of M by the Newton iteration
    X <- (mu X + (mu X)^-T) / 2 with Higham's scaling mu = |det X|^(-1/3)."""
    one_norm = M.abs().sum(-2).amax(-1)  # max column sum
    inf_norm = M.abs().sum(-1).amax(-1)  # max row sum
    norm = torch.sqrt(one_norm * inf_norm)[..., None, None]
    X = M / norm.clamp(min=1e-12)
    for _ in range(iters):
        det = torch.linalg.det(X).abs()
        mu = torch.pow(det.clamp(min=1e-12), -1.0 / 3.0)[..., None, None]
        Xs = mu * X
        X = 0.5 * (Xs + _inv3x3(Xs).transpose(-1, -2))
    return X


def solve_rigid_transform(A: torch.Tensor, B: torch.Tensor):
    """Least-squares rigid fit B ~= R @ A + t.

    A, B: (..., N, 3) corresponding point sets.
    Returns R (..., 3, 3), t (..., 3, 1) with det(R) = +1."""
    cA = A.mean(-2, keepdim=True)
    cB = B.mean(-2, keepdim=True)
    H = torch.einsum("...ni,...nj->...ij", A - cA, B - cB)
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    D = torch.diag_embed(torch.stack(
        [torch.ones_like(det), torch.ones_like(det), det], -1))
    R_svd = V @ D @ Ut
    R_polar = _polar_newton(H.transpose(-1, -2))
    R = torch.where(det[..., None, None] > 0, R_polar, R_svd)
    t = -(R @ cA.transpose(-1, -2)) + cB.transpose(-1, -2)
    return R, t


def to_homo(points: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) -> (..., N, 4)."""
    return torch.cat([points, torch.ones_like(points[..., :1])], -1)


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a (..., 4, 4) homogeneous transform to (..., N, 3) points."""
    out = torch.einsum("...ij,...nj->...ni", T, to_homo(points))
    return out[..., :3] / out[..., 3:].clamp(min=1e-9)
