"""ConvNeXt backbone of the DINO variant, XL by default.

Port of `uvhand_tpu/models/backbones/convnext.py` (the reference's
`convnext_xlarge_22k`: depths [3, 3, 27, 3], dims [256, 512, 1024, 2048],
the maps of stages 1-3, each through its own LayerNorm). A block is a 7x7
depthwise conv, LayerNorm, a 4x pointwise linear, GELU, a pointwise linear
back, the layer scale `gamma` and the residual, with stochastic depth in
train mode. Every LayerNorm has eps 1e-6. The GELU is the tanh
approximation, flax `nn.gelu`'s default, as the JAX package has it (the
reference's `nn.GELU` is exact: a divergence of the JAX package, mirrored
here).

Images in and maps out are NCHW, as `backbones/resnet.py`'s. Parameter
names are the reference's (`downsample_layers.{i}.{j}`,
`stages.{i}.{j}.{dwconv,norm,pwconv1,pwconv2,gamma}`, `norm{1,2,3}`).
`dtype` is the compute type: the input is cast to it, the convs and linears
compute in it from their float32 parameters, and every LayerNorm takes its
statistics in float32 and returns `dtype`.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.msda import dense
from .resnet import Conv2d

CONVNEXT_XL_DEPTHS = (3, 3, 27, 3)
CONVNEXT_XL_DIMS = (256, 512, 1024, 2048)
OUT_INDICES = (1, 2, 3)


def norm_f32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """`norm` over the last axis, statistics in float32, back in x's type."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map (the reference's
    `channels_first` LayerNorm)."""

    def forward(self, x):
        return norm_f32(self, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Block(nn.Module):
    def __init__(self, dim: int, drop_path: float = 0.0, layer_scale_init: float = 1e-6):
        super().__init__()
        self.drop_path = drop_path
        self.layer_scale_init = layer_scale_init
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x, generator: torch.Generator | None = None):
        y = self.dwconv(x).permute(0, 2, 3, 1)  # NHWC
        y = dense(self.pwconv1, norm_f32(self.norm, y), y.dtype)
        y = dense(self.pwconv2, F.gelu(y, approximate="tanh"), y.dtype)
        y = y * self.gamma.to(y.dtype)
        if self.training and self.drop_path > 0:
            if generator is None:
                raise ValueError("train-mode randomness draws from an explicit "
                                 "torch.Generator; pass generator=")
            keep = 1.0 - self.drop_path
            m = torch.rand((y.shape[0], 1, 1, 1), generator=generator, device=y.device) < keep
            y = y * m.to(y.dtype) / keep
        return x + y.permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    """Returns the maps of stages `OUT_INDICES` in NCHW (strides 8/16/32,
    channels dims[1:])."""

    def __init__(self, depths: Sequence[int] = CONVNEXT_XL_DEPTHS,
                 dims: Sequence[int] = CONVNEXT_XL_DIMS, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.channels = tuple(dims[i] for i in OUT_INDICES)
        self.downsample_layers = nn.ModuleList(
            [nn.Sequential(Conv2d(3, dims[0], 4, stride=4), LayerNorm2d(dims[0], eps=1e-6))]
            + [nn.Sequential(LayerNorm2d(dims[i - 1], eps=1e-6),
                             Conv2d(dims[i - 1], dims[i], 2, stride=2))
               for i in range(1, len(dims))])
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        starts = np.cumsum((0,) + tuple(depths))
        self.stages = nn.ModuleList(
            nn.Sequential(*(Block(dims[i], float(dpr[starts[i] + j])) for j in range(d)))
            for i, d in enumerate(depths))
        for i in OUT_INDICES:
            self.add_module(f"norm{i}", LayerNorm2d(dims[i], eps=1e-6))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Convs and linears ~ N(0, 1/fan_in) (the JAX default lecun-normal
        scale) with zero biases, LayerNorms at identity, layer scale 1e-6."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, Block):
                mod.gamma.fill_(mod.layer_scale_init)

    def forward(self, x, generator: torch.Generator | None = None):  # x: (B, 3, H, W)
        x = x.to(self.dtype)
        outs = []
        for i, (down, stage) in enumerate(zip(self.downsample_layers, self.stages)):
            x = down(x)
            for block in stage:
                x = block(x, generator)
            if i in OUT_INDICES:
                outs.append(getattr(self, f"norm{i}")(x))
        return outs
