"""Multi-Scale Deformable Attention (MSDA): the op, its plain version and the
`MSDeformAttn` layer.

Port of `uvhand_tpu/ops/msda.py`. Shapes (the same contract):
  value:              (B, S, M, D)   S = sum(H_l * W_l)
  spatial_shapes:     tuple ((H_0, W_0), ...) of Python ints
  sampling_locations: (B, Lq, M, L, P, 2) in [0, 1], float32
  attention_weights:  (B, Lq, M, L, P)  (already softmaxed over L*P)
  output:             (B, Lq, M * D)

For every (query, head, level, point) the value map of that level is sampled
bilinearly at pixel (x * W - 0.5, y * H - 0.5) -- grid_sample with
align_corners=False and zero padding -- and the samples are summed with the
attention weights, accumulating in float32.

`ms_deform_attn(impl="auto")` launches the hand-written CUDA kernels
(`msda_cuda.py`: `csrc/msda_fwd.cu` forward, `csrc/msda_bwd.cu` backward) for
a CUDA tensor and runs the plain versions `ms_deform_attn_torch` /
`ms_deform_attn_torch_backward` for a CPU tensor. When a gradient is needed
the op goes through `MSDeformAttnFunction`, whose backward is the backward
kernel or its plain version; autograd never differentiates the plain
forward itself, whose `abs` would give the far corner of an integer-exact
sample a gradient that the JAX package gives 0.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import msda_cuda


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


def _forward(value, spatial_shapes, loc, attn, impl):
    if impl == "auto" and value.is_cuda:
        return msda_cuda.ms_deform_attn_cuda(value, spatial_shapes, loc, attn)
    return ms_deform_attn_torch(value, spatial_shapes, loc, attn)


class MSDeformAttnFunction(torch.autograd.Function):
    """MSDA with a hand-written gradient: the forward and backward kernels
    for CUDA tensors under impl='auto', the plain versions for CPU tensors
    or under impl='torch'."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights, spatial_shapes, impl):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.spatial_shapes, ctx.impl = spatial_shapes, impl
        return _forward(value, spatial_shapes, sampling_locations, attention_weights, impl)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        if ctx.impl == "auto" and value.is_cuda:
            grads = msda_cuda.ms_deform_attn_backward_cuda(
                value, ctx.spatial_shapes, loc, attn, grad_out.contiguous())
        else:
            grads = ms_deform_attn_torch_backward(value, ctx.spatial_shapes, loc, attn, grad_out)
        return (*grads, None, None)


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    impl: str = "auto",
) -> torch.Tensor:
    """Core MSDA reduction. See the module docstring for shapes.

    impl: 'auto' (the CUDA kernels for a CUDA tensor, the plain versions for
    a CPU tensor) or 'torch' (the plain versions on any device, for holding
    the kernels against them)."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if impl not in ("auto", "torch"):
        raise ValueError(f"unknown MSDA impl {impl!r}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, sampling_locations, attention_weights)):
        return MSDeformAttnFunction.apply(value, sampling_locations, attention_weights,
                                          spatial_shapes, impl)
    return _forward(value, spatial_shapes, sampling_locations, attention_weights, impl)


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
    """MSDA layer: projections + sampling-location construction + core op.

    Keeps the reference parameter names (`sampling_offsets`,
    `attention_weights`, `value_proj`, `output_proj`). The offset and
    attention projections are linear in the same query, so they run as one
    GEMM over the concatenated weights, as the JAX layer does. Reference
    points are 2-d, or 42-d (21 keypoints) with *center refine*: the
    sampling center is the mean of the keypoints' x and of their y."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, impl: str = "auto"):
        super().__init__()
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.impl = impl
        mlp = n_heads * n_levels * n_points
        self.sampling_offsets = nn.Linear(d_model, mlp * 2)
        self.attention_weights = nn.Linear(d_model, mlp)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        nn.init.zeros_(self.sampling_offsets.weight)
        self.sampling_offsets.bias.copy_(torch.from_numpy(
            directional_offset_init(self.n_heads, self.n_levels, self.n_points)))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)
        for lin in (self.value_proj, self.output_proj):
            nn.init.xavier_uniform_(lin.weight, generator=generator)
            nn.init.zeros_(lin.bias)

    def forward(
        self,
        query: torch.Tensor,  # (B, Lq, C)
        reference_points: torch.Tensor,  # (B, Lq, L, 2) or (B, Lq, L, 42)
        input_flatten: torch.Tensor,  # (B, S, C)
        spatial_shapes: Sequence[Tuple[int, int]],
        input_padding_mask: torch.Tensor | None = None,  # (B, S) True = pad
    ) -> torch.Tensor:
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
                                  dtype=offsets.dtype, device=offsets.device)
        if reference_points.shape[-1] == 2:
            center = reference_points[:, :, None, :, None, :]
        elif reference_points.shape[-1] == 42:
            ref_x = reference_points[:, :, None, :, None, 0::2].mean(-1)
            ref_y = reference_points[:, :, None, :, None, 1::2].mean(-1)
            center = torch.stack([ref_x, ref_y], -1)
        else:
            raise ValueError(
                "reference_points last dim must be 2 or 42, got "
                f"{reference_points.shape[-1]}")
        loc = center + offsets / normalizer[None, None, None, :, None, :]

        out = ms_deform_attn(value, spatial_shapes, loc.contiguous(), attn,
                             impl=self.impl)
        return self.output_proj(out)
