"""Sine 2D position embedding (DETR style), as in `uvhand_tpu/models/posenc.py`:
normalize=True, scale=2*pi, temperature 10000, cumsum shifted by -0.5 to the
cell centres."""

from __future__ import annotations

import math

import torch


def interleaved_sincos(theta: torch.Tensor) -> torch.Tensor:
    """out[..., 2i] = sin(theta[..., 2i]), out[..., 2i+1] = cos(theta[..., 2i+1]),
    written as one sin via cos(x) == sin(x + pi/2) like the JAX module."""
    phase = (torch.arange(theta.shape[-1], device=theta.device) % 2).float() * (0.5 * math.pi)
    return torch.sin(theta + phase)


def sine_position_encoding(
    mask: torch.Tensor,  # (B, H, W) True = padding
    num_pos_feats: int = 128,
    temperature: float = 10000.0,
    scale: float = 2 * math.pi,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Returns (B, H, W, 2*num_pos_feats), channels [y-embedding, x-embedding]."""
    not_mask = (~mask).float()
    y_embed = torch.cumsum(not_mask, 1)
    x_embed = torch.cumsum(not_mask, 2)
    y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + eps) * scale
    x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + eps) * scale

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    pos_x = interleaved_sincos(x_embed[..., None] / dim_t)
    pos_y = interleaved_sincos(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], -1)
