"""ResNet-50 with frozen BatchNorm, under torchvision's parameter names.

Port of `uvhand_tpu/models/backbones/resnet.py` (plain stem only; the JAX
space-to-depth stem is a TPU rewrite of the same function). Returns the
layer2/3/4 maps (strides 8/16/32, channels 512/1024/2048) in NCHW.

`dtype` is the compute type, as in the JAX backbone: the input is cast to
it, every conv computes in it from its float32 weight, and the frozen BN
affine is applied in it, so the maps come out in `dtype`. Parameters stay
float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

RESNET50_CHANNELS = (512, 1024, 2048)
RESNET50_STRIDES = (8, 16, 32)


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm that never updates its statistics from the batch, eps 1e-5,
    under the reference's `FrozenBatchNorm2d` names.

    Its four tensors are parameters: the JAX package labels every leaf of
    its tree for the optimizer, so its AdamW trains all four at the
    backbone's rate, and the port is held against it. (The reference keeps
    them as frozen buffers; that divergence belongs to the JAX package.)"""

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
        # computed in float32, applied in the activation's type
        return (x * inv.to(x.dtype)[None, :, None, None]
                + shift.to(x.dtype)[None, :, None, None])


class Conv2d(nn.Conv2d):
    """A conv that computes in its input's type from its float32 weight and
    bias, as a flax `nn.Conv(dtype=...)`."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def _conv(cin, cout, k, stride=1, padding=0):
    return Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride=stride, padding=1)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = (
            nn.Sequential(_conv(inplanes, planes * 4, 1, stride=stride),
                          FrozenBatchNorm2d(planes * 4))
            if downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet50(nn.Module):
    """Returns (c3, c4, c5) in NCHW: strides 8/16/32, channels 512/1024/2048."""

    def __init__(self, blocks: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
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

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Convs ~ N(0, 1/fan_in) (the JAX default lecun-normal scale);
        frozen BN at identity."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)

    def forward(self, x):  # x: (B, 3, H, W)
        x = x.to(self.dtype)
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        c5 = self.layer4(c4)
        return c3, c4, c5
