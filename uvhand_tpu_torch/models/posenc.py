"""2D position embeddings (DETR style), as in `uvhand_tpu/models/posenc.py`:
the sine one (normalize=True, scale=2*pi, temperature 10000, cumsum shifted
by -0.5 to the cell centres; the DINO variant's has temperature 20 and no
shift) and the learned one (a 50x50 grid of row and column embeddings)."""

from __future__ import annotations

import math

import torch
from torch import nn


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
    center_shift: bool = True,
) -> torch.Tensor:
    """Returns (B, H, W, 2*num_pos_feats), channels [y-embedding, x-embedding].
    `center_shift=False, temperature=20.0` is the DINO variant's
    (`PositionEmbeddingSineHW`): the cumsum is not shifted to the cell
    centres."""
    not_mask = (~mask).float()
    y_embed = torch.cumsum(not_mask, 1)
    x_embed = torch.cumsum(not_mask, 2)
    shift = 0.5 if center_shift else 0.0
    y_embed = (y_embed - shift) / (y_embed[:, -1:, :] + eps) * scale
    x_embed = (x_embed - shift) / (x_embed[:, :, -1:] + eps) * scale

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    pos_x = interleaved_sincos(x_embed[..., None] / dim_t)
    pos_y = interleaved_sincos(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], -1)


class LearnedPositionEncoding(nn.Module):
    """Learned row and column embeddings (the reference's
    `PositionEmbeddingLearned`, parameters `row_embed` / `col_embed`): a
    (H, W) map takes the first W column and H row entries, channels
    [column | row]. The padding mask is not read, as in the JAX module."""

    def __init__(self, num_pos_feats: int = 128, grid: int = 50):
        super().__init__()
        self.row_embed = nn.Embedding(grid, num_pos_feats)
        self.col_embed = nn.Embedding(grid, num_pos_feats)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """uniform(0, 1), the JAX module's init."""
        self.row_embed.weight.uniform_(0.0, 1.0, generator=generator)
        self.col_embed.weight.uniform_(0.0, 1.0, generator=generator)

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        """mask (B, H, W) -> (B, H, W, 2*num_pos_feats)."""
        B, H, W = mask.shape
        x_emb = self.col_embed.weight[:W]  # (W, F)
        y_emb = self.row_embed.weight[:H]  # (H, F)
        pos = torch.cat([x_emb[None].expand(H, -1, -1), y_emb[:, None].expand(-1, W, -1)], -1)
        return pos[None].expand(B, -1, -1, -1)
