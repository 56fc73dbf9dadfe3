"""The model of the plain reference: UVHand's arctic_sf (Deformable DETR,
two-stage, box refinement, 42-d keypoint references) on the ResNet-50 with
frozen BatchNorm or the Swin-L backbone, in float32.

A frozen copy of the port's `models/` (detr.py, transformer.py,
layers.py, posenc.py, backbones/resnet.py, backbones/swin.py) for this one
model, without the options the benchmark's configurations leave off
(compute types, the single-stage model, DINO, denoising, temporal heads,
enc_lite, remat, precomputed features), and with the MSDA of
`reference/msda.py` in place of the kernels. It imports nothing of the
port. Parameters carry the port's names, so one set of seeded tensors
loads into both. Nothing here draws a weight: the benchmark loads them.

In train mode dropout (0.1, inverted, the constant rounded to float32) and
the encoder feature mask (keep 0.7, no rescale) draw from the generator
passed to `forward`, mask after mask in the order the port draws them.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .msda import MSDeformAttn

RESNET50_CHANNELS = (512, 1024, 2048)
SWIN_CHANNELS = {"swin_L_384_22k": (384, 768, 1536)}
SWIN_OUT_INDICES = (1, 2, 3)
HAND_CLASSES = (12, 13)
FROZEN_CLASSES = (0,)
INVALID_PROPOSAL = 1e4


# ------------------------------------------------------------- common parts


def rounded(x: float) -> float:
    """The constant `x` as float32 holds it."""
    return torch.tensor(x, dtype=torch.float32).item()


def keep_mask(shape, keep: float, generator: torch.Generator, device):
    return torch.rand(shape, generator=generator, device=device) < keep


class Drop(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        return torch.where(keep_mask(x.shape, keep, generator, x.device), x / rounded(keep), 0.0)


class MLP(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims, outs))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def interleaved_sincos(theta):
    phase = (torch.arange(theta.shape[-1], device=theta.device) % 2).float() * (0.5 * math.pi)
    return torch.sin(theta + phase)


def sine_position_encoding(mask, num_pos_feats=128, temperature=10000.0, scale=2 * math.pi,
                           eps=1e-6):
    """(B, H, W) padding mask -> (B, H, W, 2 * num_pos_feats), [y, x]."""
    not_mask = (~mask).float()
    y_embed = torch.cumsum(not_mask, 1)
    x_embed = torch.cumsum(not_mask, 2)
    y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + eps) * scale
    x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    return torch.cat([interleaved_sincos(y_embed[..., None] / dim_t),
                      interleaved_sincos(x_embed[..., None] / dim_t)], -1)


def layer_norm(norm: nn.LayerNorm, x):
    return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, norm.eps)


# ---------------------------------------------------------------- ResNet-50


class FrozenBatchNorm2d(nn.Module):
    """Frozen BatchNorm, eps 1e-5; its four tensors are parameters, as the
    port trains them."""

    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.running_mean = nn.Parameter(torch.zeros(n))
        self.running_var = nn.Parameter(torch.ones(n))

    def forward(self, x):
        inv = self.weight * torch.reciprocal(torch.sqrt(self.running_var + self.eps))
        shift = self.bias - self.running_mean * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]


def _conv(cin, cout, k, stride=1, padding=0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride=stride, padding=1)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(_conv(inplanes, planes * 4, 1, stride=stride),
                                         FrozenBatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet50(nn.Module):
    """(c3, c4, c5) in NCHW, strides 8/16/32."""

    def __init__(self, blocks: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, stride=2, padding=3)
        self.bn1 = FrozenBatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for li, (n, planes) in enumerate(zip(blocks, (64, 128, 256, 512))):
            layer = []
            for bi in range(n):
                stride = 2 if (bi == 0 and li > 0) else 1
                layer.append(Bottleneck(inplanes, planes, stride, downsample=bi == 0))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        return c3, c4, self.layer4(c4)


class _Joiner0(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = ResNet50()


# -------------------------------------------------------------------- Swin


def window_partition(x, ws: int):
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(wins, ws: int, H: int, W: int):
    B = wins.shape[0] // (H * W // ws // ws)
    x = wins.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + ws - 1
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shifted_window_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """(num_windows, N, N) additive mask, -100 across region boundaries."""
    img = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, h, w, :] = cnt
            cnt += 1
    wins = np.reshape(img.reshape(1, H // ws, ws, W // ws, ws, 1).transpose(0, 1, 3, 2, 4, 5),
                      (-1, ws * ws))
    mask = wins[:, None, :] - wins[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1)), persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        B_, N, C = x.shape
        h = self.num_heads
        hd = C // h
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(N, N, h).permute(2, 0, 1)
        qkv = self.qkv(x).reshape(B_, N, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * rounded(hd ** -0.5)) @ k.transpose(-1, -2)
        attn = attn + bias[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, h, N, N) + mask[None, :, None]).reshape(B_, h, N, N)
        attn = torch.softmax(attn, -1)
        return self.proj((attn @ v).transpose(1, 2).reshape(B_, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlock(nn.Module):
    """LayerNorm (eps 1e-6), window attention (every other block shifted by
    half a window under the region mask), the residual, LayerNorm, a 4x MLP
    with the tanh GELU, the residual."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x, H: int, W: int):
        B, L, C = x.shape
        ws, shift = self.window_size, self.shift
        shortcut = x
        x = layer_norm(self.norm1, x).reshape(B, H, W, C)
        pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = torch.from_numpy(shifted_window_mask(Hp, Wp, ws, shift)).to(x.device)
        x = window_reverse(self.attn(window_partition(x, ws), mask), ws, Hp, Wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        if pad_b or pad_r:
            x = x[:, :H, :W]
        x = shortcut + x.reshape(B, L, C)
        y = self.mlp.fc2(F.gelu(self.mlp.fc1(layer_norm(self.norm2, x)), approximate="tanh"))
        return x + y


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-6)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, H: int, W: int):
        B, L, C = x.shape
        x = x.reshape(B, H, W, C)
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1).reshape(B, -1, 4 * C)
        return self.reduction(layer_norm(self.norm, x))


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch: int = 4):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, embed_dim, patch, stride=patch)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)


class BasicLayer(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """The maps of stages 1-3 in NCHW (strides 8/16/32). Stochastic depth
    never runs inside the DETR, as in the port."""

    def __init__(self, embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                 window_size=12):
        super().__init__()
        dims = [embed_dim * 2 ** i for i in range(len(depths))]
        self.channels = tuple(dims[i] for i in SWIN_OUT_INDICES)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            BasicLayer([SwinBlock(dims[i], num_heads[i], window_size,
                                  0 if j % 2 == 0 else window_size // 2) for j in range(d)],
                       PatchMerging(dims[i]) if i < len(depths) - 1 else None)
            for i, d in enumerate(depths))
        for i in SWIN_OUT_INDICES:
            self.add_module(f"norm{i}", nn.LayerNorm(dims[i], eps=1e-6))

    def forward(self, x):
        B = x.shape[0]
        pe = self.patch_embed
        ph, pw = (-x.shape[2]) % pe.patch, (-x.shape[3]) % pe.patch
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        x = F.conv2d(x, pe.proj.weight, pe.proj.bias, stride=pe.patch)
        Hc, Wc = x.shape[2], x.shape[3]
        x = layer_norm(pe.norm, x.flatten(2).transpose(1, 2))
        outs = []
        for si, layer in enumerate(self.layers):
            for block in layer.blocks:
                x = block(x, Hc, Wc)
            if si in SWIN_OUT_INDICES:
                y = layer_norm(getattr(self, f"norm{si}"), x)
                outs.append(y.reshape(B, Hc, Wc, -1).permute(0, 3, 1, 2))
            if layer.downsample is not None:
                x = layer.downsample(x, Hc, Wc)
                Hc, Wc = (Hc + 1) // 2, (Wc + 1) // 2
        return outs


BACKBONES = {
    "resnet50": lambda: (_Joiner0(), RESNET50_CHANNELS),
    "swin_L_384_22k": lambda: (SwinTransformer(), SWIN_CHANNELS["swin_L_384_22k"]),
}


# ------------------------------------------------------------- transformer


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def self_attention(mha: nn.MultiheadAttention, q, v, rate: float, generator):
    """Multi-head attention from `mha`'s projections; in train mode one
    (Lq, Lk) dropout mask on the softmaxed weights, broadcast over batch and
    heads."""
    B, N, E = q.shape
    h = mha.num_heads
    w_q, w_k, w_v = mha.in_proj_weight.chunk(3)
    b_q, b_k, b_v = mha.in_proj_bias.chunk(3)

    def heads(x, w, b):
        return F.linear(x, w, b).view(B, -1, h, E // h).transpose(1, 2)

    qh = heads(q, w_q, b_q) / rounded(math.sqrt(E // h))
    weights = torch.softmax(qh @ heads(q, w_k, b_k).transpose(-1, -2), -1)
    if mha.training and rate > 0.0:
        keep = 1.0 - rate
        mask = keep_mask(weights.shape[-2:], keep, generator, q.device)
        weights = weights * (mask.float() / rounded(keep))
    out = (weights @ heads(v, w_v, b_v)).transpose(1, 2).reshape(B, N, E)
    return mha.out_proj(out)


def feed_forward(layer, x, generator):
    return layer.linear2(layer.drop(torch.relu(layer.linear1(x)), generator))


class EncoderLayer(nn.Module):
    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points, dropout):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.drop = Drop(dropout)

    def forward(self, src, pos, reference_points, spatial_shapes, padding_mask, generator):
        src2 = self.self_attn(src + pos, reference_points, src, spatial_shapes, padding_mask)
        src = self.norm1(src + self.drop(src2, generator))
        return self.norm2(src + self.drop(feed_forward(self, src, generator), generator))


class DecoderLayer(nn.Module):
    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points, dropout):
        super().__init__()
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.self_attn = nn.MultiheadAttention(d_model, n_heads, batch_first=True)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.drop = Drop(dropout)

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes, src_padding_mask,
                generator):
        tgt2 = self_attention(self.self_attn, tgt + query_pos, tgt, self.drop.rate, generator)
        tgt = self.norm2(tgt + self.drop(tgt2, generator))
        tgt2 = self.cross_attn(tgt + query_pos, reference_points, src, spatial_shapes,
                               src_padding_mask)
        tgt = self.norm1(tgt + self.drop(tgt2, generator))
        return self.norm3(tgt + self.drop(feed_forward(self, tgt, generator), generator))


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def encoder_reference_points(spatial_shapes, valid_ratios):
    dev = valid_ratios.device
    refs = []
    for lvl, (H, W) in enumerate(spatial_shapes):
        ry = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)[:, None]
        rx = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5)[None, :]
        ry, rx = ry.expand(H, W).reshape(-1), rx.expand(H, W).reshape(-1)
        ry = ry[None] / (valid_ratios[:, None, lvl, 1] * H)
        rx = rx[None] / (valid_ratios[:, None, lvl, 0] * W)
        refs.append(torch.stack([rx, ry], -1))
    return torch.cat(refs, 1)[:, :, None] * valid_ratios[:, None]


def proposal_pos_embed(proposals, num_pos_feats: int = 128):
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=proposals.device)
    dim_t = 10000.0 ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    p = torch.sigmoid(proposals) * (2 * math.pi)
    return interleaved_sincos(p[..., None] / dim_t).flatten(2)


def _class_masks(class_indices):
    hand = torch.zeros_like(class_indices, dtype=torch.bool)
    for c in HAND_CLASSES:
        hand |= class_indices == c
    obj = ~hand
    for c in FROZEN_CLASSES + HAND_CLASSES:
        obj &= class_indices != c
    return hand, obj


class DeformableTransformer(nn.Module):
    def __init__(self, d_model, n_heads, num_encoder_layers, num_decoder_layers,
                 dim_feedforward, num_feature_levels, dec_n_points, enc_n_points, num_queries,
                 dropout):
        super().__init__()
        self.d_model, self.num_queries = d_model, num_queries
        self.num_decoder_layers = num_decoder_layers
        self.encoder = _Layers(
            EncoderLayer(d_model, dim_feedforward, num_feature_levels, n_heads, enc_n_points,
                         dropout) for _ in range(num_encoder_layers))
        self.decoder = _Layers(
            DecoderLayer(d_model, dim_feedforward, num_feature_levels, n_heads, dec_n_points,
                         dropout) for _ in range(num_decoder_layers))
        self.level_embed = nn.Parameter(torch.zeros(num_feature_levels, d_model))
        self.enc_output = nn.Linear(d_model, d_model)
        self.enc_output_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.pos_trans = nn.Sequential(nn.Linear(42 * 128, 1024), nn.ReLU(),
                                       nn.Linear(1024, 1024), nn.ReLU(),
                                       nn.Linear(1024, 2 * d_model), nn.ReLU())
        self.pos_trans_norm = nn.LayerNorm(2 * d_model, eps=1e-5)
        self.two_stage_learn_xy = nn.Embedding(1, 40)

    def _gen_proposals(self, memory, padding_mask, spatial_shapes):
        B = memory.shape[0]
        dev = memory.device
        learn_xy = torch.sigmoid(self.two_stage_learn_xy.weight[0])
        props, cur = [], 0
        for lvl, (H, W) in enumerate(spatial_shapes):
            m = padding_mask[:, cur: cur + H * W].view(B, H, W)
            valid_H = (~m[:, :, 0]).sum(1).float()
            valid_W = (~m[:, 0, :]).sum(1).float()
            gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                                    torch.arange(W, dtype=torch.float32, device=dev),
                                    indexing="ij")
            grid = torch.stack([gx, gy], -1)[None]
            scale = torch.stack([valid_W, valid_H], -1).view(B, 1, 1, 2)
            grid = (grid + 0.5) / scale
            xy = (learn_xy * (2.0 ** lvl)).expand(B, H, W, 40)
            props.append(torch.cat([grid, xy], -1).reshape(B, H * W, 42))
            cur += H * W
        proposals = torch.cat(props, 1)
        valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1, keepdim=True)
        proposals = torch.log(proposals / (1 - proposals))
        proposals = proposals.masked_fill(padding_mask[..., None] | ~valid, INVALID_PROPOSAL)
        mem = memory.masked_fill(padding_mask[..., None], 0.0).masked_fill(~valid, 0.0)
        return self.enc_output_norm(self.enc_output(mem)), proposals

    def forward(self, srcs, masks, pos_embeds, cls_embed, key_embed, obj_key_embed, generator):
        spatial_shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
        src_flat = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        mask_flat = torch.cat([m.flatten(1) for m in masks], 1)
        pos_flat = torch.cat([p.flatten(1, 2) + self.level_embed[lvl][None, None]
                              for lvl, p in enumerate(pos_embeds)], 1)
        valid_ratios = torch.stack(
            [torch.stack([(~m[:, 0, :]).sum(1).float() / m.shape[2],
                          (~m[:, :, 0]).sum(1).float() / m.shape[1]], -1) for m in masks], 1)

        enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
        memory = src_flat
        for layer in self.encoder.layers:
            memory = layer(memory, pos_flat, enc_ref, spatial_shapes, mask_flat, generator)

        # two-stage: the decoder's queries from the encoder's top-k proposals
        nd = self.num_decoder_layers
        out_mem, out_props = self._gen_proposals(memory, mask_flat, spatial_shapes)
        enc_cls = cls_embed[nd](out_mem)
        root = out_props[..., 0:2].repeat(1, 1, 21)
        enc_hand = key_embed[nd](out_mem) + root
        enc_obj = obj_key_embed[nd](out_mem) + root
        topk_idx = torch.sort(enc_cls.max(-1).values, dim=1, descending=True,
                              stable=True).indices[:, :self.num_queries]

        def take(x):
            return torch.gather(x, 1, topk_idx[..., None].expand(-1, -1, x.shape[-1]))

        hand_m, obj_m = _class_masks(torch.gather(enc_cls.argmax(-1), 1, topk_idx))
        hand_kp, obj_kp = take(enc_hand).detach(), take(enc_obj).detach()
        ref_unact = take(out_props).detach()
        ref_unact = torch.where(obj_m[..., None], obj_kp, ref_unact)
        ref_unact = torch.where(hand_m[..., None], hand_kp, ref_unact)
        reference_points = torch.sigmoid(ref_unact) * 2 - 1
        pe = proposal_pos_embed(ref_unact)
        for lin in self.pos_trans[::2]:
            pe = torch.relu(lin(pe))
        query_pos, tgt = torch.split(self.pos_trans_norm(pe), self.d_model, -1)
        enc_outputs = {"pred_logits": enc_cls, "pred_hand_key_unact": enc_hand,
                       "pred_obj_key_unact": enc_obj}

        # decoder, with reference refinement gated by each layer's argmax class
        hs_list, refs_in, logits_list, deltas = [], [], [], []
        output, ref = tgt, reference_points
        vr = valid_ratios.repeat(1, 1, 21)[:, None]
        for lid, layer in enumerate(self.decoder.layers):
            refs_in.append(ref)
            output = layer(output, query_pos, ref[:, :, None] * vr, memory, spatial_shapes,
                           mask_flat, generator)
            hs_list.append(output)
            logits = cls_embed[lid](output)
            logits_list.append(logits)
            hand_m, obj_m = _class_masks(logits.argmax(-1))
            d_hand, d_obj = key_embed[lid](output), obj_key_embed[lid](output)
            deltas.append((d_hand, d_obj))
            delta = torch.where(hand_m[..., None], d_hand,
                                torch.where(obj_m[..., None], d_obj, 0.0))
            ref = (torch.sigmoid(inverse_sigmoid(ref) + delta) * 2 - 1).detach()
        hand_keys, obj_keys = [], []
        for lid, d in enumerate(deltas):
            base = inverse_sigmoid(refs_in[lid])
            hand_keys.append(torch.sigmoid(d[0] + base) * 2 - 1)
            obj_keys.append(torch.sigmoid(d[1] + base) * 2 - 1)
        return (torch.stack(hs_list), torch.stack(logits_list), torch.stack(hand_keys),
                torch.stack(obj_keys), enc_outputs)


# -------------------------------------------------------------------- DETR


class InputProj(nn.Sequential):
    def __init__(self, cin: int, d_model: int, extra_level: bool = False):
        conv = (nn.Conv2d(cin, d_model, 3, stride=2, padding=1) if extra_level
                else nn.Conv2d(cin, d_model, 1))
        super().__init__(conv, nn.GroupNorm(32, d_model, eps=1e-5))


class UVHandDETR(nn.Module):
    """arctic_sf: backbone, input projections (an extra stride-2 level),
    sine position encoding, the two-stage box-refine transformer and the
    heads (a class head and keypoint MLPs per decoder layer plus the
    encoder's; the parameter heads shared by every layer)."""

    def __init__(self, backbone="resnet50", num_classes=14, num_queries=300, d_model=256,
                 n_heads=8, num_encoder_layers=6, num_decoder_layers=6, dim_feedforward=1024,
                 num_feature_levels=4, dec_n_points=4, enc_n_points=4, dropout=0.1,
                 feature_mask_ratio=0.3, device="cpu"):
        super().__init__()
        with torch.device(device):
            body, channels = BACKBONES[backbone]()
            self.d_model, self.num_decoder_layers = d_model, num_decoder_layers
            self.num_feature_levels = num_feature_levels
            self.feature_mask_ratio = feature_mask_ratio
            self.backbone = nn.ModuleList([body])
            nb = len(channels)
            self.input_proj = nn.ModuleList(
                [InputProj(c, d_model) for c in channels]
                + [InputProj(channels[-1] if i == nb else d_model, d_model, extra_level=True)
                   for i in range(nb, num_feature_levels)])
            self.transformer = DeformableTransformer(
                d_model, n_heads, num_encoder_layers, num_decoder_layers, dim_feedforward,
                num_feature_levels, dec_n_points, enc_n_points, num_queries, dropout)
            num_pred = num_decoder_layers + 1
            self.cls_embed = nn.ModuleList(nn.Linear(d_model, num_classes)
                                           for _ in range(num_pred))
            self.key_embed = nn.ModuleList(MLP(d_model, d_model, 42, 3) for _ in range(num_pred))
            self.obj_key_embed = nn.ModuleList(MLP(d_model, d_model, 42, 3)
                                               for _ in range(num_pred))
            for name, dout in (("mano_pose_embed", 48), ("mano_beta_embed", 10),
                               ("hand_cam", 3), ("obj_cam", 3), ("obj_rot", 3), ("obj_rad", 1)):
                setattr(self, name, nn.ModuleList([nn.Linear(d_model, dout)] * num_pred))
        self.to(device)
        self.eval()

    @property
    def body(self):
        slot = self.backbone[0]
        return slot.body if isinstance(slot, _Joiner0) else slot

    def _feature_mask(self, x, generator):
        if not self.training or self.feature_mask_ratio <= 0:
            return x
        return x * keep_mask(x.shape, 1.0 - self.feature_mask_ratio, generator, x.device)

    def forward(self, images, generator=None):
        """images (B, H, W, 3) NHWC -> the output dict the criterion reads."""
        feats = self.body(images.permute(0, 3, 1, 2))
        B, H, W, _ = images.shape
        image_mask = torch.zeros(B, H, W, dtype=torch.bool, device=images.device)
        srcs = [self._feature_mask(proj(f), generator) for proj, f in zip(self.input_proj, feats)]
        for lvl in range(len(feats), self.num_feature_levels):
            src = self.input_proj[lvl](feats[-1] if lvl == len(feats) else srcs[-1])
            srcs.append(self._feature_mask(src, generator))
        masks = [F.interpolate(image_mask[:, None].float(), size=tuple(s.shape[-2:]),
                               mode="nearest-exact")[:, 0].bool() for s in srcs]
        poses = [sine_position_encoding(m, self.d_model // 2) for m in masks]
        hs, logits, hand_key, obj_key, enc = self.transformer(
            srcs, masks, poses, self.cls_embed, self.key_embed, self.obj_key_embed, generator)
        return {
            "stacked": {
                "pred_logits": logits.float(),
                "pred_hand_key": hand_key,
                "pred_obj_key": obj_key,
                "pred_mano_pose": self.mano_pose_embed[0](hs),
                "pred_mano_beta": self.mano_beta_embed[0](hs),
                "pred_hand_cam": self.hand_cam[0](hs),
                "pred_obj_cam": self.obj_cam[0](hs),
                "pred_obj_rot": self.obj_rot[0](hs),
                "pred_obj_rad": self.obj_rad[0](hs),
            },
            "interm_outputs": {
                "pred_logits": enc["pred_logits"],
                "pred_hand_key": torch.sigmoid(enc["pred_hand_key_unact"]) * 2 - 1,
                "pred_obj_key": torch.sigmoid(enc["pred_obj_key_unact"]) * 2 - 1,
            },
        }
