"""Layers that compute in the promoted type of their input and parameters.

A flax module built with `dtype=None` (`nn.Dense`, `nn.Conv`, `nn.LayerNorm`,
`nn.GroupNorm`) computes in the type that promotes its input with its
parameters: float32 for a float32 input or float32 parameters, bfloat16 only
when both are. The JAX model leaves its heads, input projections and
LayerNorms so; with float32 parameters they compute in float32 whatever the
activation's type, and with bfloat16 parameters (`--bf16_params`) they
compute in bfloat16 wherever the activation is bfloat16 too. These
subclasses keep torch's parameter names and compute as those flax modules
do: a linear or conv in the promoted type, a norm's statistics and affine in
float32 with its output cast to the promoted type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def promoted(x: torch.Tensor, weight: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, weight.dtype)


class Linear(nn.Linear):
    def forward(self, x):
        dt = promoted(x, self.weight)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        dt = promoted(x, self.weight)
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(promoted(x, self.weight))


class GroupNorm(nn.GroupNorm):
    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(promoted(x, self.weight))
