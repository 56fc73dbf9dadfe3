"""Swin Transformer backbone, Swin-L by default (the reference's
`swin_L_384_22k`: embed 192, depths 2/2/18/2, heads 6/12/24/48, window 12,
the maps of stages 1-3 with 384, 768 and 1536 channels).

Port of `uvhand_tpu/models/backbones/swin.py`. A block is LayerNorm, window
attention with a relative-position bias (the map padded to whole windows,
every other block cyclically shifted by half a window under the -100
region mask), the residual, LayerNorm, a 4x MLP with GELU and the residual;
patch merging concatenates each 2x2 neighbourhood (odd sides padded first)
and halves the channels' growth with a bias-free linear. As in the JAX
module, and unlike the reference:
  - every LayerNorm has eps 1e-6 (flax's default) and the GELU is the tanh
    approximation (flax's `nn.gelu`),
  - the patch embedding pads as flax's 'SAME' 4x4 stride-4 conv does,
  - the cyclic shift stays on where the padded map is one window.
Inside a window, the queries are scaled before the product, the bias is
gathered from the table through the index, the shifted mask is added in
float32, and the softmax runs in float32 and is cast back to the compute
type.

Stochastic depth (rates spread by `linspace(0, drop_path_rate)` over the
blocks, one per-sample draw at each of a block's two residual branches)
runs only where the caller passes `train=True`, the JAX module's argument
(default False), not with `module.train()`: the JAX DETR calls its backbone
without it, so inside `UVHandDETR` it never runs. Its masks come from the
explicit `generator` (`drop_path_masks`), or are given (`drop_masks`), the
draws apart from the arithmetic.

Images in and maps out are NCHW, as `backbones/resnet.py`'s; inside, the
tokens are (B, H*W, C) as in the JAX module. Parameter names are the
official Swin names (`patch_embed.proj`, `patch_embed.norm`,
`layers.{i}.blocks.{j}.{norm1, attn.relative_position_bias_table, attn.qkv,
attn.proj, norm2, mlp.fc1, mlp.fc2}`, `layers.{i}.downsample.{norm,
reduction}`, `norm{1,2,3}`), which the JAX package's
`convert_swin_checkpoint` reads; the relative-position index is a buffer
outside the state dict. `dtype` is the compute type: the convs and linears
compute in it from float32 parameters and every LayerNorm takes its
statistics in float32 and returns it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.msda import dense
from ..transformer import rounded
from .convnext import norm_f32

SWIN_L_CHANNELS = (384, 768, 1536)
OUT_INDICES = (1, 2, 3)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/ws * W/ws, ws*ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(wins: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    B = wins.shape[0] // (H * W // ws // ws)
    x = wins.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2ws-1)^2-row bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0) + ws - 1
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def shifted_window_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """(num_windows, N, N) additive mask, -100 across region boundaries."""
    img = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, h, w, :] = cnt
            cnt += 1
    wins = np.reshape(
        img.reshape(1, H // ws, ws, W // ws, ws, 1).transpose(0, 1, 3, 2, 4, 5),
        (-1, ws * ws),
    )
    mask = wins[:, None, :] - wins[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


_MASKS: dict = {}


def _window_mask(H: int, W: int, ws: int, shift: int, device) -> torch.Tensor:
    """`shifted_window_mask` as a float32 tensor on `device`, made once per
    shape and device (a host copy each call would sync the stream)."""
    key = (H, W, ws, shift, torch.device(device))
    if key not in _MASKS:
        _MASKS[key] = torch.from_numpy(shifted_window_mask(H, W, ws, shift)).to(device)
    return _MASKS[key]


def drop_path(v: torch.Tensor, mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """v * mask / (1 - rate) per sample (mask (B,) bool), the constant in v's
    type as JAX takes it; `mask` None is the identity."""
    if mask is None:
        return v
    keep = 1.0 - rate
    return v * mask.to(v.dtype).reshape(-1, 1, 1) / rounded(keep, v.dtype)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.window_size, self.dtype = num_heads, window_size, dtype
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1).astype(np.int64)), persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B_, N, C) windows; mask (num_windows, N, N) float32 or None."""
        B_, N, C = x.shape
        h, dt = self.num_heads, self.dtype
        hd = C // h
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(N, N, h).permute(2, 0, 1)
        qkv = dense(self.qkv, x, dt).reshape(B_, N, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B_, h, N, hd)
        attn = (q * rounded(hd ** -0.5, dt)) @ k.transpose(-1, -2)
        attn = attn + bias[None].to(attn.dtype)
        if mask is not None:
            # the float32 mask promotes the scores to float32, as in JAX
            nW = mask.shape[0]
            attn = attn.float().reshape(B_ // nW, nW, h, N, N) + mask[None, :, None]
            attn = attn.reshape(B_, h, N, N)
        attn = torch.softmax(attn.float(), -1).to(dt)
        out = (attn @ v).transpose(1, 2).reshape(B_, N, C)
        return dense(self.proj, out, dt)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.window_size, self.shift, self.drop_path, self.dtype = (window_size, shift,
                                                                    drop_path, dtype)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = WindowAttention(dim, num_heads, window_size, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, H: int, W: int,
                masks: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]] = (None, None)):
        """x (B, H*W, C); `masks` the per-sample keep masks of the two
        stochastic-depth sites (None: off)."""
        B, L, C = x.shape
        ws, shift, dt = self.window_size, self.shift, self.dtype
        shortcut = x
        x = norm_f32(self.norm1, x).reshape(B, H, W, C)
        # the full window always (tiny maps are padded to one window)
        pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = _window_mask(Hp, Wp, ws, shift, x.device)
        x = window_reverse(self.attn(window_partition(x, ws), mask), ws, Hp, Wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        if pad_b or pad_r:
            x = x[:, :H, :W]
        x = shortcut + drop_path(x.reshape(B, L, C), masks[0], self.drop_path)
        y = dense(self.mlp.fc1, norm_f32(self.norm2, x), dt)
        y = dense(self.mlp.fc2, F.gelu(y, approximate="tanh"), dt)
        return x + drop_path(y, masks[1], self.drop_path)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * dim, eps=1e-6)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, L, C = x.shape
        x = x.reshape(B, H, W, C)
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1).reshape(B, -1, 4 * C)
        return F.linear(norm_f32(self.norm, x), self.reduction.weight.to(self.dtype))


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch: int = 4):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, embed_dim, patch, stride=patch)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)


class BasicLayer(nn.Module):
    """A stage: its blocks and the patch merging after it (none after the
    last stage), under the official `layers.{i}` names."""

    def __init__(self, blocks, downsample: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """Returns the maps of stages `OUT_INDICES` in NCHW (strides 8/16/32,
    channels `channels`)."""

    def __init__(self, embed_dim: int = 192, depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (6, 12, 24, 48), window_size: int = 12,
                 drop_path_rate: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.depths = tuple(depths)
        dims = [embed_dim * 2 ** i for i in range(len(depths))]
        self.channels = tuple(dims[i] for i in OUT_INDICES)
        self.patch_embed = PatchEmbed(embed_dim)
        self.drop_path_rates = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        starts = np.cumsum((0,) + self.depths)
        self.layers = nn.ModuleList(
            BasicLayer([SwinBlock(dims[i], num_heads[i], window_size,
                                  shift=0 if j % 2 == 0 else window_size // 2,
                                  drop_path=self.drop_path_rates[starts[i] + j], dtype=dtype)
                        for j in range(d)],
                       PatchMerging(dims[i], dtype) if i < len(depths) - 1 else None)
            for i, d in enumerate(depths))
        for i in OUT_INDICES:
            self.add_module(f"norm{i}", nn.LayerNorm(dims[i], eps=1e-6))

    @classmethod
    def swin_l_384(cls, **kw):
        return cls(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                   window_size=12, **kw)

    @classmethod
    def swin_t(cls, **kw):
        return cls(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                   window_size=7, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Convs and linears ~ N(0, 1/fan_in) (the JAX default lecun-normal
        scale) with zero biases, LayerNorms at identity, bias tables ~
        N(0, 0.02) truncated at 2 sigma."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.weight[0].numel()),
                                   generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, WindowAttention):
                nn.init.trunc_normal_(mod.relative_position_bias_table, std=0.02, a=-0.04,
                                      b=0.04, generator=generator)

    def drop_path_masks(self, batch: int, generator: torch.Generator,
                        device=None) -> List[Tuple[Optional[torch.Tensor], ...]]:
        """Per block, the keep masks (B,) of its two sites in order, each
        drawn as `rand < 1 - rate` from `generator`; None where the rate is
        0 (the first block), which draws nothing."""
        out = []
        for rate in self.drop_path_rates:
            if rate <= 0:
                out.append((None, None))
                continue
            out.append(tuple(torch.rand(batch, generator=generator, device=device) < 1.0 - rate
                             for _ in range(2)))
        return out

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                drop_masks: Sequence[Tuple[Optional[torch.Tensor], ...]] | None = None):
        """x (B, 3, H, W). With `train`, stochastic depth draws its masks
        from `generator` (`drop_path_masks`) unless `drop_masks` gives them."""
        B = x.shape[0]
        dt = self.dtype
        pe = self.patch_embed
        # flax 'SAME': the total padding (-H) % 4, its smaller half first
        ph, pw = (-x.shape[2]) % pe.patch, (-x.shape[3]) % pe.patch
        x = F.pad(x.to(dt), (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        x = F.conv2d(x, pe.proj.weight.to(dt), pe.proj.bias.to(dt), stride=pe.patch)
        Hc, Wc = x.shape[2], x.shape[3]
        x = norm_f32(pe.norm, x.flatten(2).transpose(1, 2))
        if train and drop_masks is None:
            if generator is None:
                raise ValueError("train-mode randomness draws from an explicit "
                                 "torch.Generator; pass generator=")
            drop_masks = self.drop_path_masks(B, generator, x.device)
        if not train:
            drop_masks = None
        outs = []
        blk = 0
        for si, layer in enumerate(self.layers):
            for block in layer.blocks:
                x = block(x, Hc, Wc, (None, None) if drop_masks is None else drop_masks[blk])
                blk += 1
            if si in OUT_INDICES:
                y = norm_f32(getattr(self, f"norm{si}"), x)
                outs.append(y.reshape(B, Hc, Wc, -1).permute(0, 3, 1, 2))
            if layer.downsample is not None:
                x = layer.downsample(x, Hc, Wc)
                Hc, Wc = (Hc + 1) // 2, (Wc + 1) // 2
        return outs
