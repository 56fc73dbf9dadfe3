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

Two formulations of that function, as in the JAX package's TPU kernels:
  - the gather form (`csrc/msda_fwd.cu`, `csrc/msda_bwd.cu`; plain versions
    `ms_deform_attn_torch`, `ms_deform_attn_torch_backward`), the default;
  - the factorized form (`csrc/msda_fac_fwd.cu`, `csrc/msda_fac_bwd.cu`;
    plain versions `ms_deform_attn_fac_torch`,
    `ms_deform_attn_fac_torch_backward`): rows first, then columns, with
    the TPU kernels' bf16 rounding points. It is taken where `fac_ok` holds:
    `UVHAND_MSDA_FAC=1` and the TPU row table fits (every level side <= 128,
    WD <= 4096), the shapes on which the JAX package takes it.

`ms_deform_attn(impl="auto")` launches the hand-written CUDA kernels
(`msda_cuda.py`) for a CUDA tensor and runs the plain versions for a CPU
tensor; `impl="torch"` runs the plain versions on any device. Before a
launch `kernel_inputs` brings the caller's tensors into the form the
kernels take (locations in the arithmetic type, contiguous tensors in the
types the kernels take, an aligned value) without changing the function,
so the op takes on the card every input type it takes on the CPU (float32,
bfloat16, float16, float64, attention of another type). When a
gradient is needed the op goes through `MSDeformAttnFunction`, whose
backward is the backward kernel or its plain version of the formulation
its forward ran; autograd never differentiates a plain forward itself,
whose `abs` would give the far corner of an integer-exact sample a gradient
that the JAX package gives 0.
"""

from __future__ import annotations

import math
import os
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


def fac_ok(spatial_shapes: Sequence[Tuple[int, int]], D: int) -> bool:
    """True where the JAX package's `_fac_ok` takes the factorized kernels:
    `UVHAND_MSDA_FAC=1`, every level side <= 128 (the TPU row table has 128
    rows) and the lane-padded row-table width WD = sum of the levels'
    W * D rounded up to 128 at most 4096. Read at every call."""
    if os.environ.get("UVHAND_MSDA_FAC", "0") != "1":
        return False
    wd = sum(-(-w * D // 128) * 128 for _, w in spatial_shapes)
    return all(h <= 128 and w <= 128 for h, w in spatial_shapes) and wd <= 4096


def _rounder(dtype):
    """Rounding to the value's type, as the TPU factorized kernels round
    their operands to it; the identity in float32 and float64."""
    if dtype in (torch.float32, torch.float64):
        return lambda x: x
    return lambda x: x.to(dtype).to(torch.float32)


def _fac_sample(loc, attention_weights, lvl, p, H, W, ft):
    """Per-sample quantities of the factorized kernels at (level, point):
    attention, then per row r = floor(py) + dy its index, in-map flag, tent
    and tent sign (where(|d| < 1, sign(d), 0)), and likewise per column."""
    px = loc[:, :, :, lvl, p, 0] * W - 0.5
    py = loc[:, :, :, lvl, p, 1] * H - 0.5
    a = attention_weights[:, :, :, lvl, p].to(ft)
    zero = torch.zeros((), dtype=ft, device=loc.device)

    def axis(pos, size):
        start = torch.floor(pos)
        out = []
        for k in (0, 1):
            idx = start + k
            dist = pos - idx
            sgn = torch.where(dist.abs() < 1.0, torch.sign(dist), zero)
            out.append((idx, (idx >= 0) & (idx < size), 1.0 - dist.abs(), sgn))
        return out

    return a, axis(py, H), axis(px, W)


def ms_deform_attn_fac_torch(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the factorized forward kernel (`msda_fac_fwd.cu`),
    the function of the TPU's `_fwd_kernel_fac`: per (level, point) the row
    tents ay (rounded to the value's type) combine the sample's rows into
    T[c] = sum_r ay[r] v[r, c] (float32), and the output adds
    round(round(a * ax[c]) * T[c]) over the sample's columns c. Only the
    <= 2 rows and columns of the sample's support inside the map take part.
    It repeats the kernel's arithmetic in its order, so the two agree bit
    for bit (the kernel is built without fused multiply-add)."""
    B, S, M, D = value.shape
    Lq, L, P = sampling_locations.shape[1], sampling_locations.shape[3], sampling_locations.shape[4]
    dev = value.device
    vflat = value.reshape(B * S * M, D)
    base = (torch.arange(B, device=dev).view(B, 1, 1) * (S * M)
            + torch.arange(M, device=dev).view(1, 1, M))
    ft = torch.promote_types(value.dtype, torch.float32)
    rnd = _rounder(value.dtype)
    loc = sampling_locations.to(ft)
    acc = torch.zeros(B, Lq, M, D, dtype=ft, device=dev)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        for p in range(P):
            a, rows, cols = _fac_sample(loc, attention_weights, lvl, p, H, W, ft)
            for cx, cvalid, hx, _ in cols:
                awx = rnd(a * hx)
                t = torch.zeros_like(acc)
                for cy, rvalid, hy, _ in rows:
                    valid = rvalid & cvalid
                    cell = torch.where(valid, cy * W + cx, 0.0).long()
                    v = vflat[base + (start + cell) * M].to(ft)
                    t = t + torch.where(valid[..., None], rnd(hy)[..., None] * v, 0.0)
                acc = acc + torch.where(cvalid[..., None], rnd(awx[..., None] * t), 0.0)
        start += H * W
    return acc.to(value.dtype).reshape(B, Lq, M * D)


def ms_deform_attn_fac_torch_backward(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the factorized backward kernel (`msda_fac_bwd.cu`),
    the function of the TPU's `_bwd_kernel_fac` -> (dvalue in the value's
    type, dloc float32, dattn in the attention's type). Per (level, point),
    with ay, ax the row and column tents rounded to the value's type,
    axg = ax[c] g and T[c] = sum_r ay[r] v[r, c]:
      dv[r, c] += ay[r] round(a axg)
      dattn = sum_c sum_d round(axg T[c])
      dpy = -a sum_r sgn_y[r] round(Q[r]),  Q[r] = sum_c sum_d round(axg) v[r, c]
      dpx = -a sum_c sgn_x[c] round(R[c]),  R[c] = sum_d round(g T[c])
    and dloc = (dpx * W, dpy * H). Sums over the channels are taken in the
    kernel's warp order (`_warp_sum`), so dattn and dloc repeat the kernel
    bit for bit; dvalue's sums are in another order (the kernel's are
    float32 atomics)."""
    B, S, M, D = value.shape
    Lq, L, P = sampling_locations.shape[1], sampling_locations.shape[3], sampling_locations.shape[4]
    dev = value.device
    vflat = value.reshape(B * S * M, D)
    ft = torch.promote_types(value.dtype, torch.float32)
    rnd = _rounder(value.dtype)
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
            a, rows, cols = _fac_sample(loc, attention_weights, lvl, p, H, W, ft)
            s_daw = torch.zeros_like(g)
            s_q = [torch.zeros_like(g), torch.zeros_like(g)]
            r_sums = []
            for cx, cvalid, hx, _ in cols:
                axg = rnd(hx)[..., None] * g
                h = rnd(a[..., None] * axg)
                axg_r = rnd(axg)
                t = torch.zeros_like(g)
                vs = []
                for cy, rvalid, hy, _ in rows:
                    valid = (rvalid & cvalid)[..., None]
                    cell = torch.where(valid[..., 0], cy * W + cx, 0.0).long()
                    rows_idx = base + (start + cell) * M
                    v = vflat[rows_idx].to(ft)
                    ay = rnd(hy)[..., None]
                    t = t + torch.where(valid, ay * v, 0.0)
                    dvalue.index_add_(0, rows_idx.reshape(-1),
                                      torch.where(valid, ay * h, 0.0).reshape(-1, D))
                    vs.append((valid, v))
                cv = cvalid[..., None]
                s_daw = s_daw + torch.where(cv, rnd(axg * t), 0.0)
                for k, (valid, v) in enumerate(vs):
                    s_q[k] = s_q[k] + torch.where(valid, axg_r * v, 0.0)
                r_sums.append(_warp_sum(torch.where(cv, rnd(g * t), 0.0)))
            gy = gx = torch.zeros_like(a)
            for (_, rvalid, _, sgn), q in zip(rows, s_q):
                gy = gy + torch.where(rvalid, sgn * rnd(_warp_sum(q)), zero)
            for (_, cvalid, _, sgn), r in zip(cols, r_sums):
                gx = gx + torch.where(cvalid, sgn * rnd(r), zero)
            dattn[:, :, :, lvl, p] = _warp_sum(s_daw)
            dloc[:, :, :, lvl, p, 0] = -(a * gx) * W
            dloc[:, :, :, lvl, p, 1] = -(a * gy) * H
        start += H * W
    return (dvalue.view(B, S, M, D).to(value.dtype), dloc.to(sampling_locations.dtype),
            dattn.to(attention_weights.dtype))


def kernel_inputs(value, sampling_locations, attention_weights, fac, grad_out=None):
    """The op's inputs in the form the CUDA kernels take, for the function
    the plain versions compute on the caller's tensors -> (value, locations,
    attention, grad_out or None):
      - locations in the plain versions' arithmetic type: float32, or
        float64 for a float64 value;
      - value and incoming gradient contiguous and in one type, the
        attention in it too or, in the factorized form, in the arithmetic
        type. The gather form computes a bfloat16 or float16 value in
        float32, so a float16 value, or a bfloat16 one with attention of
        another type, is widened (exactly) and the kernels run in float32;
        a bfloat16 value with bfloat16 attention stays (the model paths'
        staged kernels). The factorized form rounds at the value's type, so
        the value keeps it, and attention of another type is made the
        arithmetic type, which its general kernels read;
      - the value's data 16-byte aligned (the staged kernels copy it by
        16-byte chunks): a fresh copy, which the allocator aligns.
    Tensors already in that form come back as they are. The caller casts
    the results back to the caller's types."""
    arith = torch.promote_types(value.dtype, torch.float32)
    own = attention_weights.dtype == value.dtype
    if fac:
        work, attn_type = value.dtype, value.dtype if own else arith
    else:
        work = value.dtype if value.dtype == arith or (own and value.dtype == torch.bfloat16) \
            else arith
        attn_type = work
    value = value.to(work).contiguous()
    if value.data_ptr() % 16:
        value = value.clone()
    if grad_out is not None:
        grad_out = grad_out.to(work).contiguous()
    return (value, sampling_locations.to(arith).contiguous(),
            attention_weights.to(attn_type).contiguous(), grad_out)


def _forward(value, spatial_shapes, loc, attn, impl, fac):
    if impl == "auto" and value.is_cuda:
        kernel = msda_cuda.ms_deform_attn_fac_cuda if fac else msda_cuda.ms_deform_attn_cuda
        v, lc, a, _ = kernel_inputs(value, loc, attn, fac)
        return kernel(v, spatial_shapes, lc, a).to(value.dtype)
    plain = ms_deform_attn_fac_torch if fac else ms_deform_attn_torch
    return plain(value, spatial_shapes, loc, attn)


class MSDeformAttnFunction(torch.autograd.Function):
    """MSDA with a hand-written gradient: the forward and backward kernels
    for CUDA tensors under impl='auto', the plain versions for CPU tensors
    or under impl='torch'. `fac` picks the factorized formulation; the
    forward stores it, so the backward runs the same one whatever the
    environment says by then. Gradients come back in each input's type."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights, spatial_shapes, impl, fac):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.spatial_shapes, ctx.impl, ctx.fac = spatial_shapes, impl, fac
        return _forward(value, spatial_shapes, sampling_locations, attention_weights, impl, fac)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        shapes = ctx.spatial_shapes
        if ctx.impl == "auto" and value.is_cuda:
            kernel = (msda_cuda.ms_deform_attn_fac_backward_cuda if ctx.fac
                      else msda_cuda.ms_deform_attn_backward_cuda)
            v, lc, a, g = kernel_inputs(value, loc, attn, ctx.fac, grad_out)
            dvalue, dloc, dattn = kernel(v, shapes, lc, a, g)
            grads = (dvalue.to(value.dtype), dloc.to(loc.dtype), dattn.to(attn.dtype))
        else:
            plain = (ms_deform_attn_fac_torch_backward if ctx.fac
                     else ms_deform_attn_torch_backward)
            grads = plain(value, shapes, loc, attn, grad_out)
        return (*grads, None, None, None)


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
    the kernels against them). The formulation is the factorized one where
    `fac_ok` holds, else the gather form."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if impl not in ("auto", "torch"):
        raise ValueError(f"unknown MSDA impl {impl!r}")
    fac = fac_ok(spatial_shapes, value.shape[-1])
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, sampling_locations, attention_weights)):
        return MSDeformAttnFunction.apply(value, sampling_locations, attention_weights,
                                          spatial_shapes, impl, fac)
    return _forward(value, spatial_shapes, sampling_locations, attention_weights, impl, fac)


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


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`layer` computed in `dtype` from its float32 parameters, as a flax
    `nn.Dense(dtype=dtype)` computes: input, weight and bias cast to it."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class MSDeformAttn(nn.Module):
    """MSDA layer: projections + sampling-location construction + core op.

    Keeps the reference parameter names (`sampling_offsets`,
    `attention_weights`, `value_proj`, `output_proj`). The offset and
    attention projections are linear in the same query, so they run as one
    GEMM over the concatenated weights, as the JAX layer does. Reference
    points are 2-d, or 42-d (21 keypoints) with *center refine*: the
    sampling center is the mean of the keypoints' x and of their y.

    `compute_dtype` is the value path's type, as in the JAX layer: the
    value and output projections compute in it, the value and the attention
    weights enter the op in it; the offset/attention GEMM computes in the
    promoted type of the query and the parameters (float32 unless both are
    bfloat16), the sampling locations are float32, and the output is
    float32."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, impl: str = "auto",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.impl = impl
        self.compute_dtype = compute_dtype
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

        dt = self.compute_dtype
        value = dense(self.value_proj, input_flatten, dt)
        if input_padding_mask is not None:
            value = value.masked_fill(input_padding_mask[..., None], 0.0)
        value = value.view(B, S, M, D)

        w_qa = torch.cat([self.sampling_offsets.weight, self.attention_weights.weight])
        b_qa = torch.cat([self.sampling_offsets.bias, self.attention_weights.bias])
        # in the promoted type of the query and the parameters, as the JAX
        # layer's `query @ w_qa + b_qa`: float32 unless both are bfloat16
        qt = torch.promote_types(query.dtype, w_qa.dtype)
        qa = F.linear(query.to(qt), w_qa.to(qt), b_qa.to(qt))  # (B, Lq, M*L*P*3)
        offsets = qa[..., : M * L * P * 2].reshape(B, Lq, M, L, P, 2)
        attn = qa[..., M * L * P * 2:].reshape(B, Lq, M, L * P)
        attn = torch.softmax(attn, -1).view(B, Lq, M, L, P)

        normalizer = torch.tensor([[w, h] for h, w in spatial_shapes],
                                  dtype=torch.float32, device=offsets.device)
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

        out = ms_deform_attn(value, spatial_shapes, loc.contiguous(), attn.to(dt),
                             impl=self.impl)
        return dense(self.output_proj, out, dt).float()
