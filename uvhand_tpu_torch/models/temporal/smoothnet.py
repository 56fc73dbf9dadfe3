"""SmoothNet-style temporal smoothing over prediction windows.

Port of `uvhand_tpu/models/temporal/smoothnet.py` (the reference's
`models/smoothnet.py`):
  - `Smoother` (:28-63): linears over the TIME axis (window -> 512 -> 3
    residual blocks (256 hidden, LeakyReLU 0.2, dropout of rate 0.9) ->
    window), LeakyReLU 0.1 after the encoder;
  - `MotionSmoother` (:66-125): position, velocity and acceleration
    branches and a fusion linear; needs a window of at least 3;
  - `ArcticSmoother` (:128-178): six smoothers over the selected-query
    parameters (`mano_root` serves both hands' roots, `mano_pose` both
    poses, `mano_shape` both betas);
  - the train-time noise (engine.py:337-344), split into its draws
    (`noise_draws`, from an explicit generator) and their use
    (`apply_noise`), so a test can inject the JAX package's draws;
  - `smoothnet_loss` (loss_arctic_sf.py:402-...): contact deviation of both
    hands and the acceleration errors, weighted 10 / 1 / 1.
Dropout is active in train mode (`module.train()`) and draws from the
`generator` passed to `forward`. Weights are drawn by
`reset_parameters(generator)` (xavier-uniform linears, zero biases).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...evaluation.metrics import eval_acc_pose
from ...losses.criterion import CONTACT_DIST
from ..layers import Linear
from ..transformer import Drop

#: the train-time noise's scale of each selected parameter
NOISE_SCALES = {"root.l": 0.1, "root.r": 0.1, "root.o": 0.1, "pose.l": 0.1, "pose.r": 0.1,
                "beta.l": 0.1, "beta.r": 0.1, "obj_rot": 5.0, "obj_rad": 0.1}
#: smoothnet_loss's weights (util/scripts.py:16-29)
LOSS_WEIGHTS = {"loss/cd": 10.0, "acc/h": 1.0, "acc/o": 1.0}


class SmootherResBlock(nn.Module):
    def __init__(self, dim: int, hidden: int = 256, dropout: float = 0.9):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self.drop = Drop(dropout)

    def forward(self, x, generator=None):
        y = F.leaky_relu(self.drop(self.fc1(x), generator), 0.2)
        y = F.leaky_relu(self.drop(self.fc2(y), generator), 0.2)
        return y + x


class Smoother(nn.Module):
    """(N, C, window_size) -> (N, C, output_size)."""

    def __init__(self, window_size: int, output_size: int, hidden_size: int = 512,
                 res_hidden_size: int = 256, num_blocks: int = 3, dropout: float = 0.9):
        super().__init__()
        self.encoder = Linear(window_size, hidden_size)
        self.res = nn.ModuleList(SmootherResBlock(hidden_size, res_hidden_size, dropout)
                                 for _ in range(num_blocks))
        self.decoder = Linear(hidden_size, output_size)

    def forward(self, x, generator=None):
        x = F.leaky_relu(self.encoder(x), 0.1)
        for block in self.res:
            x = block(x, generator)
        return self.decoder(x)


class MotionSmoother(nn.Module):
    """(B, T, C) -> (B, T, C) over windows of `window_size` >= 3 frames."""

    def __init__(self, window_size: int, output_size: int):
        super().__init__()
        if window_size < 3:
            raise ValueError(f"MotionSmoother needs window_size >= 3 (acc branch), "
                             f"got {window_size}")
        self.pos = Smoother(window_size, output_size)
        self.vel = Smoother(window_size - 1, output_size)
        self.acc = Smoother(window_size - 2, output_size)
        self.fusion = Linear(3 * output_size, output_size)

    def forward(self, x, generator=None):
        x = x.transpose(1, 2)  # (B, C, T)
        vel = x[..., 1:] - x[..., :-1]
        acc = vel[..., 1:] - vel[..., :-1]
        y = torch.cat([self.pos(x, generator), self.vel(vel, generator),
                       self.acc(acc, generator)], 2)
        return self.fusion(y).transpose(1, 2)


class ArcticSmoother(nn.Module):
    """The six smoothers over flat (B*T, ·) selected parameters, rows in
    windows of `window_size` consecutive frames; returns the same keys."""

    NAMES = ("mano_root", "obj_root", "mano_pose", "mano_shape", "obj_rot", "obj_rad")

    def __init__(self, window_size: int, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.window_size = window_size
        for name in self.NAMES:
            setattr(self, name, MotionSmoother(window_size, window_size))
        self.reset_parameters(generator)
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                nn.init.xavier_uniform_(mod.weight, generator=generator)
                nn.init.zeros_(mod.bias)

    def forward(self, selected: Dict[str, torch.Tensor], generator=None):
        T = self.window_size

        def smooth(smoother, x, d):
            return smoother(x.reshape(-1, T, d), generator).reshape(-1, d)

        out = dict(selected)
        for key, name, d in (("root.l", "mano_root", 3), ("root.r", "mano_root", 3),
                             ("root.o", "obj_root", 3), ("pose.l", "mano_pose", 48),
                             ("pose.r", "mano_pose", 48), ("beta.l", "mano_shape", 10),
                             ("beta.r", "mano_shape", 10), ("obj_rot", "obj_rot", 3)):
            out[key] = smooth(getattr(self, name), selected[key], d)
        out["obj_rad"] = smooth(self.obj_rad, selected["obj_rad"][:, None], 1)[:, 0]
        return out


def noise_draws(generator: torch.Generator, selected: Dict[str, torch.Tensor]):
    """{key: (uniform, normal)}: the train-time noise's draws for each key
    of `NOISE_SCALES`, in its order, each of the parameter's shape."""
    return {k: (torch.rand(selected[k].shape, generator=generator, device=selected[k].device),
                torch.randn(selected[k].shape, generator=generator, device=selected[k].device))
            for k in NOISE_SCALES}


def apply_noise(selected: Dict[str, torch.Tensor], draws, p_mask: float = 0.05):
    """x + N(0, scale) where the uniform draw > 1 - p_mask (a share p_mask
    of the entries), else x."""
    out = dict(selected)
    for k, s in NOISE_SCALES.items():
        u, n = draws[k]
        out[k] = selected[k] + torch.where(u > 1 - p_mask, n * s, torch.zeros_like(n))
    return out


def inject_param_noise(generator: torch.Generator, selected: Dict[str, torch.Tensor],
                       p_mask: float = 0.05):
    """Train-time corruption of the base model's selected parameters."""
    return apply_noise(selected, noise_draws(generator, selected), p_mask)


def nan0(x: torch.Tensor) -> torch.Tensor:
    """The mean over the non-NaN entries of `x`, 0 where there is none."""
    m = ~torch.isnan(x)
    n = m.sum()
    return torch.where(n > 0, torch.nansum(x) / n.clamp(min=1), torch.zeros((), device=x.device))


def smoothnet_loss(pred: Dict[str, torch.Tensor], gt: Dict[str, torch.Tensor]):
    """-> (total, {"loss/cd", "acc/h", "acc/o", "total"}) for decoded
    camera-space predictions and targets ordered by time (B*T frames)."""

    def contact_dev(v_obj, v_hand, dist, idx, hand_valid):
        corres = torch.gather(v_obj, 1, idx.long()[..., None].expand(-1, -1, 3))
        disp = torch.linalg.norm(corres - v_hand, dim=-1)
        contact = (dist <= CONTACT_DIST) & (hand_valid[:, None] > 0)
        per = (disp * contact).sum(1) / contact.sum(1).clamp(min=1)
        has = contact.sum(1) > 0
        return (per * has).sum() / has.sum().clamp(min=1)

    is_valid = gt["is_valid"]
    cd = contact_dev(pred["object.v.cam"], pred["mano.v3d.cam.r"], gt["dist.ro"], gt["idx.ro"],
                     gt["right_valid"] * is_valid) \
        + contact_dev(pred["object.v.cam"], pred["mano.v3d.cam.l"], gt["dist.lo"],
                      gt["idx.lo"], gt["left_valid"] * is_valid)
    acc = eval_acc_pose(pred, gt)
    losses = {"loss/cd": cd, "acc/h": nan0(acc["acc/h"]), "acc/o": nan0(acc["acc/o"])}
    total = sum(LOSS_WEIGHTS[k] * v for k, v in losses.items())
    losses["total"] = total
    return total, losses
