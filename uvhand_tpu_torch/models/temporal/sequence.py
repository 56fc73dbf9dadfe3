"""Temporal heads over prediction windows.

Port of `uvhand_tpu/models/temporal/sequence.py`:
  - `BiLSTM`: the ARCTIC baseline's bidirectional LSTM
    (arctic_tools/src/models/arctic_lstm/model.py:36-61) over the window
    axis, as `torch.nn.LSTM(bidirectional=True)`. The JAX package runs two
    flax `OptimizedLSTMCell` scans (the backward one over the reversed
    frames, its outputs reversed back), zero initial carry; torch's packed
    gates `[i, f, g, o]` hold the cell's `ii/if/ig/io` input kernels and
    `hi/hf/hg/ho` recurrent kernels, and `bias_hh` its recurrent biases.
    The cell has no input bias: `bias_ih` stays zero and takes no gradient
    (`train/convert.py` maps the trees);
  - `TemporalAttention`: the ViViT-style pre-norm temporal transformer
    (flax `LayerNorm` eps 1e-6, the tanh form of GELU, flax's multi-head
    attention: `transformer.self_attention`, no dropout) with learned temporal position
    embeddings (`max_window` rows, the first T used);
  - `TemporalLSTMBlock`: in_proj -> BiLSTM(dim // 2) -> out_proj;
  - `TemporalParamHead`: one block per selected parameter (`PARAM_SPECS`),
    `x + block(x)` over windows of `window_size` consecutive rows; the rows
    are padded with the last one up to a whole window and cut back.
Every block's `out_proj` starts at zero, so a fresh head is the identity.
Modules take (B, T, C) windows and keep their shape. Weights are drawn by
`reset_parameters(generator)`.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import LayerNorm, Linear, promoted
from ..transformer import self_attention

#: the selected parameters a temporal head refines, and their widths
PARAM_SPECS = (("root.l", 3), ("root.r", 3), ("root.o", 3), ("pose.l", 48), ("pose.r", 48),
               ("beta.l", 10), ("beta.r", 10), ("obj_rot", 3), ("obj_rad", 1))


class BiLSTM(nn.Module):
    """(B, T, C) -> (B, T, 2 * hidden): the forward direction's outputs,
    then the backward direction's."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.lstm = nn.LSTM(in_dim, hidden, batch_first=True, bidirectional=True)
        for name in ("bias_ih_l0", "bias_ih_l0_reverse"):
            getattr(self.lstm, name).requires_grad_(False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        bound = 1.0 / math.sqrt(self.hidden)
        for name, p in self.lstm.named_parameters():
            if name.startswith("weight"):
                p.uniform_(-bound, bound, generator=generator)
            else:
                p.zero_()

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        return self.lstm(xs)[0]


class TemporalAttention(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int = 2, heads: int = 4,
                 mlp_ratio: float = 2.0, max_window: int = 64):
        super().__init__()
        self.temporal_pos = nn.Parameter(torch.zeros(max_window, dim))
        self.in_proj = Linear(in_dim, dim)
        self.ln1 = nn.ModuleList(LayerNorm(dim, eps=1e-6) for _ in range(depth))
        self.attn = nn.ModuleList(nn.MultiheadAttention(dim, heads, batch_first=True)
                                  for _ in range(depth))
        self.ln2 = nn.ModuleList(LayerNorm(dim, eps=1e-6) for _ in range(depth))
        self.fc1 = nn.ModuleList(Linear(dim, int(dim * mlp_ratio)) for _ in range(depth))
        self.fc2 = nn.ModuleList(Linear(int(dim * mlp_ratio), dim) for _ in range(depth))
        self.out_proj = Linear(dim, in_dim)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        x = self.in_proj(xs) + self.temporal_pos[: xs.shape[1]]
        for ln1, attn, ln2, fc1, fc2 in zip(self.ln1, self.attn, self.ln2, self.fc1, self.fc2):
            y = ln1(x)
            x = x + self_attention(attn, y, y, 0.0, None, promoted(y, attn.in_proj_weight))
            x = x + fc2(F.gelu(fc1(ln2(x)), approximate="tanh"))
        return self.out_proj(x)


class TemporalLSTMBlock(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.in_proj = Linear(in_dim, dim)
        self.bilstm = BiLSTM(dim, dim // 2)
        self.out_proj = Linear(dim, in_dim)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        return self.out_proj(self.bilstm(self.in_proj(xs)))


BLOCKS = {"vivit": TemporalAttention, "lstm": TemporalLSTMBlock}


class TemporalParamHead(nn.Module):
    """Refines the selected parameters of consecutive rows (flattened
    windows of `window_size` frames) with a residual temporal block each
    (`ta_<name>`, kind "vivit" or "lstm", width `dim`)."""

    def __init__(self, window_size: int, dim: int = 256, kind: str = "vivit"):
        super().__init__()
        if kind not in BLOCKS:
            raise ValueError(f"unknown temporal head kind {kind!r}: lstm or vivit")
        self.window_size = window_size
        for name, d in PARAM_SPECS:
            setattr(self, self.block_name(name), BLOCKS[kind](d, dim))

    @staticmethod
    def block_name(name: str) -> str:
        return "ta_" + name.replace(".", "_")

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Xavier-uniform linears and attention projections with zero biases,
        LSTM weights ~ U(+-1/sqrt(hidden)), temporal positions ~ N(0, 0.02),
        and every `out_proj` zero."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                nn.init.xavier_uniform_(mod.weight, generator=generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.MultiheadAttention):
                nn.init.xavier_uniform_(mod.in_proj_weight, generator=generator)
                nn.init.zeros_(mod.in_proj_bias)
            elif isinstance(mod, BiLSTM):
                mod.reset_parameters(generator)
            elif isinstance(mod, TemporalAttention):
                mod.temporal_pos.normal_(0.0, 0.02, generator=generator)
        for name, _ in PARAM_SPECS:
            getattr(self, self.block_name(name)).out_proj.weight.zero_()

    def forward(self, selected: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        T = self.window_size
        out = dict(selected)
        for name, d in PARAM_SPECS:
            x = selected[name]
            flat = x.reshape(-1, d)
            B = flat.shape[0]
            pad = -B % T
            if pad:
                flat = torch.cat([flat, flat[-1:].expand(pad, d)])
            x2 = flat.reshape(-1, T, d)
            y = x2 + getattr(self, self.block_name(name))(x2)
            out[name] = y.reshape(-1, d)[:B].reshape(x.shape)
        return out
