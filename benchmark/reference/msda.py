"""Multi-scale deformable attention (MSDA) of the plain reference, in
plain torch: the bilinear sampling of each level map at (x * W - 0.5,
y * H - 0.5) with zero padding (grid_sample's align_corners=False), summed
with the attention weights in float32, its hand-written gradient, and the
`MSDeformAttn` layer (offset and attention projections, 42-d
center-refined reference points).

A frozen copy of the port's plain versions in `ops/msda.py`
(`ms_deform_attn_torch`, `ms_deform_attn_torch_backward`, the layer), the
gather form, without the CUDA kernels, the factorized form or the compute
type; it imports nothing of the port. The forward repeats the kernels'
arithmetic step for step; the gradient of the value is summed in another
order than the kernels' atomics.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def ms_deform_attn_torch(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the CUDA kernel: 4-corner gathers, zero padding,
    float32 accumulation (float64 for float64 inputs).

    It repeats the kernel's arithmetic step for step -- the same expressions,
    each rounded on its own, summed over levels, points and the four corners
    in the kernel's order -- so the two agree bit for bit in float32 (the
    kernel is built without fused multiply-add for this reason). A corner
    outside the level map contributes nothing: its weight is set to 0 and
    its row index to a valid dummy row."""
    B, S, M, D = value.shape
    Lq, L, P = sampling_locations.shape[1], sampling_locations.shape[3], sampling_locations.shape[4]
    dev = value.device
    vflat = value.reshape(B * S * M, D)
    # row of value[b, s, m] in vflat is (b * S + s) * M + m
    base = (torch.arange(B, device=dev).view(B, 1, 1) * (S * M)
            + torch.arange(M, device=dev).view(1, 1, M))
    ft = torch.promote_types(value.dtype, torch.float32)
    loc = sampling_locations.to(ft)
    acc = torch.zeros(B, Lq, M, D, dtype=ft, device=dev)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        for p in range(P):
            px = loc[:, :, :, lvl, p, 0] * W - 0.5
            py = loc[:, :, :, lvl, p, 1] * H - 0.5
            a = attention_weights[:, :, :, lvl, p].to(ft)
            x0 = torch.floor(px)
            y0 = torch.floor(py)
            for dy in (0, 1):
                cy = y0 + dy
                hy = 1.0 - (py - cy).abs()
                for dx in (0, 1):
                    cx = x0 + dx
                    hx = 1.0 - (px - cx).abs()
                    valid = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
                    w = torch.where(valid, a * (hy * hx), 0.0)
                    cell = torch.where(valid, cy * W + cx, 0.0).long()
                    rows = base + (start + cell) * M
                    acc = acc + w[..., None] * vflat[rows].to(ft)
        start += H * W
    return acc.to(value.dtype).reshape(B, Lq, M * D)


def _warp_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the backward kernel's order: per chunk of
    32 channels (zero-padded) the warp's xor butterfly 16, 8, 4, 2, 1, then
    the chunks in order."""
    pad = (-x.shape[-1]) % 32
    if pad:
        x = F.pad(x, (0, pad))
    x = x.reshape(x.shape[:-1] + (-1, 32))
    for off in (16, 8, 4, 2, 1):
        x = x[..., :off] + x[..., off:2 * off]
    total = x[..., 0, 0]
    for c in range(1, x.shape[-2]):
        total = total + x[..., c, 0]
    return total


def ms_deform_attn_torch_backward(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the CUDA backward kernel -> (dvalue in the value's
    type, dloc float32, dattn in the attention's type); sums in float32
    (float64 throughout for float64 inputs).

    Gather form with the forward's corner loop: per in-map corner c the dot
    <g, v_c> (in the kernel's order, `_warp_sum`), then
    dattn = sum_c w_c dot_c, dpx = -a sum_c sx_c hy_c dot_c with
    sx_c = sign(px - cx_c) where the corner's x tent is > 0 (so sign(0) = 0
    at a kink, as in the JAX backward), likewise dpy, and
    dloc = (dpx * W, dpy * H). dvalue gathers a * w_c * g back onto the
    corner rows with `index_add_`. dattn and dloc repeat the kernel's
    arithmetic in its order; dvalue's sums are in another order (the
    kernel's are atomics)."""
    B, S, M, D = value.shape
    Lq, L, P = sampling_locations.shape[1], sampling_locations.shape[3], sampling_locations.shape[4]
    dev = value.device
    vflat = value.reshape(B * S * M, D)
    ft = torch.promote_types(value.dtype, torch.float32)
    g = grad_out.reshape(B, Lq, M, D).to(ft)
    base = (torch.arange(B, device=dev).view(B, 1, 1) * (S * M)
            + torch.arange(M, device=dev).view(1, 1, M))
    loc = sampling_locations.to(ft)
    dvalue = torch.zeros(B * S * M, D, dtype=ft, device=dev)
    dloc = torch.empty(B, Lq, M, L, P, 2, dtype=ft, device=dev)
    dattn = torch.empty(B, Lq, M, L, P, dtype=ft, device=dev)
    zero = torch.zeros((), dtype=ft, device=dev)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        for p in range(P):
            px = loc[:, :, :, lvl, p, 0] * W - 0.5
            py = loc[:, :, :, lvl, p, 1] * H - 0.5
            a = attention_weights[:, :, :, lvl, p].to(ft)
            x0 = torch.floor(px)
            y0 = torch.floor(py)
            da = gx = gy = torch.zeros_like(px)
            for dy in (0, 1):
                cy = y0 + dy
                hy = 1.0 - (py - cy).abs()
                sy = torch.where(hy > 0, torch.sign(py - cy), zero)
                for dx in (0, 1):
                    cx = x0 + dx
                    hx = 1.0 - (px - cx).abs()
                    sx = torch.where(hx > 0, torch.sign(px - cx), zero)
                    valid = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
                    wc = hy * hx
                    cell = torch.where(valid, cy * W + cx, 0.0).long()
                    rows = base + (start + cell) * M
                    dot = _warp_sum(g * vflat[rows].to(ft))
                    da = da + torch.where(valid, wc * dot, zero)
                    gx = gx + torch.where(valid, (sx * hy) * dot, zero)
                    gy = gy + torch.where(valid, (sy * hx) * dot, zero)
                    aw = torch.where(valid, a * wc, zero)
                    dvalue.index_add_(0, rows.reshape(-1), (aw[..., None] * g).reshape(-1, D))
            dattn[:, :, :, lvl, p] = da
            dloc[:, :, :, lvl, p, 0] = -(a * gx) * W
            dloc[:, :, :, lvl, p, 1] = -(a * gy) * H
        start += H * W
    return (dvalue.view(B, S, M, D).to(value.dtype), dloc.to(sampling_locations.dtype),
            dattn.to(attention_weights.dtype))


class MSDeformAttnFunction(torch.autograd.Function):
    """MSDA with the hand-written gradient of `ms_deform_attn_torch_backward`
    (autograd never differentiates the forward itself, whose `abs` would
    give the far corner of an integer-exact sample a gradient)."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights, spatial_shapes):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.spatial_shapes = spatial_shapes
        return ms_deform_attn_torch(value, spatial_shapes, sampling_locations,
                                    attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        grads = ms_deform_attn_torch_backward(value, ctx.spatial_shapes, loc, attn, grad_out)
        return (*grads, None)


def ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights):
    """The MSDA reduction; through `MSDeformAttnFunction` where a gradient
    is needed."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, sampling_locations, attention_weights)):
        return MSDeformAttnFunction.apply(value, sampling_locations, attention_weights,
                                          spatial_shapes)
    return ms_deform_attn_torch(value, spatial_shapes, sampling_locations, attention_weights)


def directional_offset_init(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Reference bias init for sampling offsets: head h points along angle
    2*pi*h/M, L-inf normalized, scaled by point id."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # (M, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)



class MSDeformAttn(nn.Module):
    """MSDA layer: value projection, one GEMM for the sampling offsets and
    the attention logits, softmax over levels x points, sampling locations
    around the reference points (for 42-d references the mean of the 21 x
    and of the 21 y coordinates), the reduction and the output projection."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        mlp = n_heads * n_levels * n_points
        self.sampling_offsets = nn.Linear(d_model, mlp * 2)
        self.attention_weights = nn.Linear(d_model, mlp)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, reference_points, input_flatten, spatial_shapes,
                input_padding_mask=None):
        B, Lq, _ = query.shape
        S = input_flatten.shape[1]
        M, L, P = self.n_heads, self.n_levels, self.n_points
        D = self.d_model // M
        value = self.value_proj(input_flatten)
        if input_padding_mask is not None:
            value = value.masked_fill(input_padding_mask[..., None], 0.0)
        value = value.view(B, S, M, D)
        w_qa = torch.cat([self.sampling_offsets.weight, self.attention_weights.weight])
        b_qa = torch.cat([self.sampling_offsets.bias, self.attention_weights.bias])
        qa = F.linear(query, w_qa, b_qa)  # (B, Lq, M*L*P*3)
        offsets = qa[..., : M * L * P * 2].reshape(B, Lq, M, L, P, 2)
        attn = qa[..., M * L * P * 2:].reshape(B, Lq, M, L * P)
        attn = torch.softmax(attn, -1).view(B, Lq, M, L, P)
        normalizer = torch.tensor([[w, h] for h, w in spatial_shapes],
                                  dtype=torch.float32, device=offsets.device)
        if reference_points.shape[-1] == 2:
            center = reference_points[:, :, None, :, None, :]
        else:
            ref_x = reference_points[:, :, None, :, None, 0::2].mean(-1)
            ref_y = reference_points[:, :, None, :, None, 1::2].mean(-1)
            center = torch.stack([ref_x, ref_y], -1)
        loc = center + offsets / normalizer[None, None, None, :, None, :]
        out = ms_deform_attn(value, spatial_shapes, loc.contiguous(), attn)
        return self.output_proj(out)
