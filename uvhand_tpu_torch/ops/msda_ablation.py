"""The MSDA backward's ablation variants: plain versions and dispatch.

Port of the variants of the TPU ablation bench
(`scripts/bench_msda_ablation.py`, its kernels `kernel` at `:1064` and
`kernel_xdot` at `:1022`), over the op's own layouts rather than Mosaic's
padded ones:
  inputs   value (B, S, M, D), sampling_locations (B, Lq, M, L, P, 2),
           attention_weights (B, Lq, M, L, P), grad_out g (B, Lq, M*D);
  outputs  dvalue (B, S, M, D) float32 and dpy, dpx, daw (B, Lq, M, L, P)
           float32, the gradients with respect to the pixel coordinates
           (px = x * W - 0.5, py = y * H - 0.5) and the attention, before the
           chain rule into the locations.

Variants (each also runs on the card through its kernel in `msda_cuda.py`):
  - `ablate_backward_torch(..., out, gate)`: the gather backward of
    `ms_deform_attn_torch_backward` with one output's work dropped (`out`:
    'full'; 'nodpy' dpy = dpx = a; 'nodaw' daw = a; 'nodv' dvalue = 0) and
    the tent gate `gate` 'where' (sign(d) where the tent is > 0, else 0) or
    'eq' (+1 on a sample's near corner, -1 on its far one, the TPU's
    `[s == floor(p)] - [s == floor(p) + 1]`; it differs from 'where' only at
    integer-exact coordinates). Kernel: `msda_ablate_bwd` (csrc/msda_bwd.cu).
  - `onlyg_torch`: the dense floor. G[q, s] = sum_d g[q, d] v[s, d] over every
    token, dvalue = round(G)^T g (round: to the value's type), daw = G at
    level 0's first L*P tokens, dpy = dpx = 0. Kernel: csrc/msda_onlyg.cu.
  - `xdot_torch(G, ...)`: the per-point work between the two GEMMs of the
    `xdot` variant: from the dense plane G (B*M, Lq, S) in the value's type,
    dpy, dpx, daw read at each sample's in-map corners and the dense weight
    plane ws = sum of a * tent over the row's points, rounded to the value's
    type. `xdot_backward` adds the GEMMs: G = g v^T before, dvalue = ws^T g
    after (`torch.matmul`, as the JAX code leaves them to XLA). Kernel:
    csrc/msda_xdot.cu.

Each plain version repeats its kernel's arithmetic in its order, so the two
agree bit for bit in float32 (the kernels are built without fused
multiply-add), except where a kernel sums with atomics (dvalue of the gather
variants) or in another order (onlyg's dvalue). The dispatchers
(`ablate_backward`, `onlyg`, `xdot`) launch the kernels for CUDA tensors
under impl='auto' and run the plain versions for CPU tensors or under
impl='torch'.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import msda_cuda
from .msda import _rounder, _warp_sum

OUTS = ("full", "nodpy", "nodaw", "nodv")
GATES = ("where", "eq")

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _dims(value, loc):
    B, S, M, D = value.shape
    return B, S, M, D, loc.shape[1], loc.shape[3], loc.shape[4]


def ablate_backward_torch(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,
    out: str = "full",
    gate: str = "where",
) -> Grads:
    """Plain version of `msda_ablate_bwd` -> (dvalue, dpy, dpx, daw), float32
    (float64 for float64 inputs). The corner loop and sums of
    `ms_deform_attn_torch_backward`; see the module docstring for `out` and
    `gate`."""
    if out not in OUTS or gate not in GATES:
        raise ValueError(f"unknown ablation out={out!r} or gate={gate!r}")
    B, S, M, D, Lq, L, P = _dims(value, sampling_locations)
    dev = value.device
    vflat = value.reshape(B * S * M, D)
    ft = torch.promote_types(value.dtype, torch.float32)
    g = grad_out.reshape(B, Lq, M, D).to(ft)
    base = (torch.arange(B, device=dev).view(B, 1, 1) * (S * M)
            + torch.arange(M, device=dev).view(1, 1, M))
    loc = sampling_locations.to(ft)
    dvalue = torch.zeros(B * S * M, D, dtype=ft, device=dev)
    dpy, dpx, daw = (torch.empty(B, Lq, M, L, P, dtype=ft, device=dev) for _ in range(3))
    zero = torch.zeros((), dtype=ft, device=dev)

    def sign_gate(pos, corner, tent, near):
        if gate == "eq":
            return 1.0 if near else -1.0
        return torch.where(tent > 0, torch.sign(pos - corner), zero)

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
                sy = sign_gate(py, cy, hy, dy == 0)
                for dx in (0, 1):
                    cx = x0 + dx
                    hx = 1.0 - (px - cx).abs()
                    sx = sign_gate(px, cx, hx, dx == 0)
                    valid = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
                    wc = hy * hx
                    cell = torch.where(valid, cy * W + cx, 0.0).long()
                    rows = base + (start + cell) * M
                    dot = _warp_sum(g * vflat[rows].to(ft))
                    if out != "nodaw":
                        da = da + torch.where(valid, wc * dot, zero)
                    if out != "nodpy":
                        gx = gx + torch.where(valid, (sx * hy) * dot, zero)
                        gy = gy + torch.where(valid, (sy * hx) * dot, zero)
                    if out != "nodv":
                        aw = torch.where(valid, a * wc, zero)
                        dvalue.index_add_(0, rows.reshape(-1), (aw[..., None] * g).reshape(-1, D))
            dpy[:, :, :, lvl, p] = a if out == "nodpy" else -(a * gy)
            dpx[:, :, :, lvl, p] = a if out == "nodpy" else -(a * gx)
            daw[:, :, :, lvl, p] = a if out == "nodaw" else da
        start += H * W
    return dvalue.view(B, S, M, D), dpy, dpx, daw


def _per_head(value, grad_out, ft):
    """value (B, S, M, D) -> (B, M, S, D) and g (B, Lq, M*D) -> (B, M, Lq, D), in ft."""
    B, S, M, D = value.shape
    g = grad_out.reshape(B, -1, M, D)
    return value.to(ft).permute(0, 2, 1, 3), g.to(ft).permute(0, 2, 1, 3)


def onlyg_torch(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,
) -> Grads:
    """Plain version of the dense `onlyg` kernel -> (dvalue, dpy = 0, dpx = 0,
    daw), float32. G is summed over the channels in order 0..D-1, as the
    kernel sums it, so G and daw agree with it bit for bit; round(G)^T g is
    one matrix product (another order than the kernel's)."""
    B, S, M, D, Lq, L, P = _dims(value, sampling_locations)
    h0, w0 = spatial_shapes[0]
    if h0 * w0 < L * P:
        raise ValueError(f"onlyg reads daw off level 0's first L*P = {L * P} tokens; "
                         f"level 0 has {h0 * w0}")
    ft = torch.promote_types(value.dtype, torch.float32)
    v, g = _per_head(value, grad_out, ft)
    G = g[..., :, None, 0] * v[..., None, :, 0]  # (B, M, Lq, S)
    for d in range(1, D):
        G = G + g[..., :, None, d] * v[..., None, :, d]
    daw = G[..., :L * P].permute(0, 2, 1, 3).reshape(B, Lq, M, L, P).contiguous()
    dvalue = torch.matmul(_rounder(value.dtype)(G).transpose(-1, -2), g)  # (B, M, S, D)
    zeros = torch.zeros_like(daw)
    return dvalue.permute(0, 2, 1, 3).contiguous(), zeros, zeros.clone(), daw


def xdot_torch(
    G: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> Grads:
    """Plain version of the `xdot` kernel -> (dpy, dpx, daw float32, ws in
    G's type (B*M, Lq, S)). dpy, dpx and daw sum over each sample's in-map
    corners in the kernel's order; ws adds a * tent into a float32 plane one
    (level, point) after the other, as the kernel's row owner does, and
    rounds it to G's type once."""
    loc = sampling_locations
    B, Lq, M, L, P = loc.shape[:5]
    S = G.shape[-1]
    dev = G.device
    ft = torch.promote_types(G.dtype, torch.float32)
    Gflat = G.reshape(-1)
    # row (b, q, m) of the plane starts at ((b * M + m) * Lq + q) * S
    rowbase = ((torch.arange(B, device=dev).view(B, 1, 1) * M
                + torch.arange(M, device=dev).view(1, 1, M)) * Lq
               + torch.arange(Lq, device=dev).view(1, Lq, 1)) * S
    locf = loc.to(ft)
    ws = torch.zeros(B * M * Lq * S, dtype=ft, device=dev)
    dpy, dpx, daw = (torch.empty(B, Lq, M, L, P, dtype=ft, device=dev) for _ in range(3))
    zero = torch.zeros((), dtype=ft, device=dev)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        for p in range(P):
            px = locf[:, :, :, lvl, p, 0] * W - 0.5
            py = locf[:, :, :, lvl, p, 1] * H - 0.5
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
                    idx = rowbase + start + torch.where(valid, cy * W + cx, 0.0).long()
                    g_c = Gflat[idx].to(ft)
                    da = da + torch.where(valid, wc * g_c, zero)
                    gx = gx + torch.where(valid, (sx * hy) * g_c, zero)
                    gy = gy + torch.where(valid, (sy * hx) * g_c, zero)
                    ws.index_add_(0, idx.reshape(-1), torch.where(valid, a * wc, zero).reshape(-1))
            dpy[:, :, :, lvl, p] = -(a * gy)
            dpx[:, :, :, lvl, p] = -(a * gx)
            daw[:, :, :, lvl, p] = da
        start += H * W
    return dpy, dpx, daw, ws.view(B * M, Lq, S).to(G.dtype)


def _on_card(t, impl):
    if impl not in ("auto", "torch"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl == "auto" and t.is_cuda


def ablate_backward(value, spatial_shapes, sampling_locations, attention_weights, grad_out,
                    out="full", gate="where", impl="auto") -> Grads:
    """The ablation backward: the kernel for CUDA tensors under impl='auto',
    else `ablate_backward_torch`."""
    args = (value, spatial_shapes, sampling_locations, attention_weights, grad_out)
    if _on_card(value, impl):
        return msda_cuda.ms_deform_attn_ablate_backward_cuda(*args, out=out, gate=gate)
    return ablate_backward_torch(*args, out=out, gate=gate)


def onlyg(value, spatial_shapes, sampling_locations, attention_weights, grad_out,
          impl="auto") -> Grads:
    """The dense `onlyg` variant: the kernel for CUDA tensors under
    impl='auto', else `onlyg_torch`."""
    args = (value, spatial_shapes, sampling_locations, attention_weights, grad_out)
    if _on_card(value, impl):
        return msda_cuda.ms_deform_attn_onlyg_cuda(*args)
    return onlyg_torch(*args)


def xdot(G, spatial_shapes, sampling_locations, attention_weights, impl="auto") -> Grads:
    """The per-point part of `xdot`: the kernel for CUDA tensors under
    impl='auto', else `xdot_torch`."""
    args = (G, spatial_shapes, sampling_locations, attention_weights)
    if _on_card(G, impl):
        return msda_cuda.ms_deform_attn_xdot_cuda(*args)
    return xdot_torch(*args)


def dense_plane(value: torch.Tensor, grad_out: torch.Tensor) -> torch.Tensor:
    """G = g v^T per (batch, head) over every query and token, (B*M, Lq, S)
    in the value's type: one batched `torch.matmul` (float32 sums, rounded
    once to the value's type), the GEMM the JAX code runs before `xdot`."""
    B, S, M, D = value.shape
    v = value.permute(0, 2, 1, 3).reshape(B * M, S, D)
    g = grad_out.reshape(B, -1, M, D).permute(0, 2, 1, 3).reshape(B * M, -1, D)
    return torch.matmul(g, v.transpose(1, 2))


def xdot_backward(value, spatial_shapes, sampling_locations, attention_weights, grad_out,
                  impl="auto") -> Grads:
    """The whole `xdot` variant -> (dvalue, dpy, dpx, daw) float32: the GEMM
    `dense_plane`, then `xdot`, then dvalue = ws^T g as a float32
    `torch.matmul` of the widened operands (bf16 products are exact in
    float32; the JAX GEMM also sums in float32)."""
    B, S, M, D = value.shape
    G = dense_plane(value, grad_out)
    dpy, dpx, daw, ws = xdot(G, spatial_shapes, sampling_locations, attention_weights, impl)
    del G
    g = grad_out.reshape(B, -1, M, D).permute(0, 2, 1, 3).reshape(B * M, -1, D)
    dv = torch.matmul(ws.transpose(1, 2).float(), g.float())  # (B*M, S, D)
    return dv.view(B, M, S, D).permute(0, 2, 1, 3).contiguous(), dpy, dpx, daw
