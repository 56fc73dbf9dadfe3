"""UVHand DETR: ResNet-50 + deformable transformer + output heads.

Port of `uvhand_tpu/models/detr.py` for `feature_type="origin"`,
`backbone="resnet50"`, two-stage with box refinement:
  - input projections: per-level 1x1 conv + GroupNorm(32), plus an extra
    stride-2 3x3 level from the last backbone map,
  - heads per decoder layer: class and keypoints (used inside the
    transformer), mano pose 48 / beta 10, hand cam 3, obj cam 3, obj rot 3,
    obj radian 1 (the non-class heads share weights across layers),
  - per-layer 42-d keypoint outputs and the encoder's interm outputs in
    [-1, 1] via sigmoid*2-1,
  - train mode (`model.train()`): dropout in the transformer and the
    encoder feature mask (each input-projected element kept with
    probability 1 - feature_mask_ratio, with no rescale), both drawn from
    the `torch.Generator` passed to `forward`.

Images enter NHWC like the JAX model and are permuted to NCHW for the
backbone. The output dict has the JAX model's keys (`stacked`,
`aux_outputs`, `interm_outputs`, ...). Parameter names are the reference's
state-dict names (see `train/convert.py`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.msda import MSDeformAttn
from .backbones.resnet import RESNET50_CHANNELS, ResNet50
from .posenc import sine_position_encoding
from .transformer import MLP, DeformableTransformer, keep_mask


def resize_mask(mask: torch.Tensor, size) -> torch.Tensor:
    """(B, H, W) bool -> (B, h, w) bool, nearest neighbour with half-pixel
    centres, as `jax.image.resize(..., "nearest")` does ("nearest-exact";
    torch's plain "nearest" does not use the centres)."""
    return F.interpolate(mask[:, None].float(), size=tuple(size),
                         mode="nearest-exact")[:, 0].bool()


class InputProj(nn.Sequential):
    """1x1 conv (3x3 stride 2 for the extra level) + GroupNorm(32, eps 1e-5),
    as the reference's `input_proj.{i}.0` / `.1`."""

    def __init__(self, cin: int, d_model: int, extra_level: bool = False):
        conv = (nn.Conv2d(cin, d_model, 3, stride=2, padding=1) if extra_level
                else nn.Conv2d(cin, d_model, 1))
        super().__init__(conv, nn.GroupNorm(32, d_model, eps=1e-5))


class _Joiner0(nn.Module):
    """Slot 0 of the reference's `Joiner(backbone, position_embedding)`:
    keeps the ResNet under `.body` for the `backbone.0.body.*` names."""

    def __init__(self):
        super().__init__()
        self.body = ResNet50()


class UVHandDETR(nn.Module):
    def __init__(self, num_classes: int = 14, num_queries: int = 300,
                 d_model: int = 256, n_heads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 1024, num_feature_levels: int = 4,
                 dec_n_points: int = 4, enc_n_points: int = 4,
                 dropout: float = 0.1, feature_mask_ratio: float = 0.3,
                 generator: torch.Generator | None = None, device=None):
        """Builds the model with weights drawn from `generator` on `device`
        (the CUDA card unless `device="cpu"` is given), in eval mode."""
        super().__init__()
        device = resolve_device(device)
        self.d_model = d_model
        self.feature_mask_ratio = feature_mask_ratio
        self.num_decoder_layers = num_decoder_layers
        self.num_feature_levels = num_feature_levels
        self.backbone = nn.ModuleList([_Joiner0()])
        nb = len(RESNET50_CHANNELS)
        self.input_proj = nn.ModuleList(
            [InputProj(c, d_model) for c in RESNET50_CHANNELS]
            + [InputProj(RESNET50_CHANNELS[-1] if i == nb else d_model, d_model,
                         extra_level=True)
               for i in range(nb, num_feature_levels)])
        self.transformer = DeformableTransformer(
            d_model=d_model, n_heads=n_heads,
            num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers,
            dim_feedforward=dim_feedforward,
            num_feature_levels=num_feature_levels,
            dec_n_points=dec_n_points, enc_n_points=enc_n_points,
            num_queries=num_queries, dropout=dropout)
        num_pred = num_decoder_layers + 1  # two-stage: the extra one is the encoder head
        self.cls_embed = nn.ModuleList(nn.Linear(d_model, num_classes) for _ in range(num_pred))
        self.key_embed = nn.ModuleList(MLP(d_model, d_model, 42, 3) for _ in range(num_pred))
        self.obj_key_embed = nn.ModuleList(MLP(d_model, d_model, 42, 3) for _ in range(num_pred))
        # the reference registers ONE module per output head num_pred times
        for name, dout in (("mano_pose_embed", 48), ("mano_beta_embed", 10),
                           ("hand_cam", 3), ("obj_cam", 3), ("obj_rot", 3),
                           ("obj_rad", 1)):
            setattr(self, name, nn.ModuleList([nn.Linear(d_model, dout)] * num_pred))
        self.reset_parameters(generator)
        self.to(device)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Random weights from `generator`: xavier-uniform linears and convs
        with zero biases, the MSDA offset/attention init, level embeddings
        ~ N(0, 1), the focal-loss prior on the class biases, and the
        two-stage xy spread at logit(0.05)."""
        for mod in self.modules():
            # (the backbone's bias-free convs are drawn by its own reset below)
            if isinstance(mod, (nn.Linear, nn.Conv2d)) and mod.bias is not None:
                nn.init.xavier_uniform_(mod.weight, generator=generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.MultiheadAttention):
                nn.init.xavier_uniform_(mod.in_proj_weight, generator=generator)
                nn.init.zeros_(mod.in_proj_bias)
        self.backbone[0].body.reset_parameters(generator)
        for mod in self.modules():
            if isinstance(mod, MSDeformAttn):
                mod.reset_parameters(generator)
        self.transformer.level_embed.normal_(0.0, 1.0, generator=generator)
        self.transformer.two_stage_learn_xy.weight.fill_(math.log(0.05 / (1 - 0.05)))
        for head in self.cls_embed:
            head.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def _feature_mask(self, x: torch.Tensor, generator: torch.Generator | None):
        if not self.training or self.feature_mask_ratio <= 0:
            return x
        # the reference applies no 1/keep rescale
        return x * keep_mask(x.shape, 1.0 - self.feature_mask_ratio, generator, x.device)

    def level_features(self, images: torch.Tensor, image_mask: torch.Tensor | None = None,
                       generator: torch.Generator | None = None):
        """(srcs (B, C, H_l, W_l), masks (B, H_l, W_l), pos (B, H_l, W_l, C))
        for every level, from NHWC images."""
        feats = self.backbone[0].body(images.permute(0, 3, 1, 2))
        B, H, W, _ = images.shape
        if image_mask is None:
            image_mask = torch.zeros(B, H, W, dtype=torch.bool, device=images.device)
        srcs = [self._feature_mask(proj(f), generator) for proj, f in zip(self.input_proj, feats)]
        for lvl in range(len(feats), self.num_feature_levels):
            src = self.input_proj[lvl](feats[-1] if lvl == len(feats) else srcs[-1])
            srcs.append(self._feature_mask(src, generator))
        masks = [resize_mask(image_mask, s.shape[-2:]) for s in srcs]
        poses = [sine_position_encoding(m, self.d_model // 2) for m in masks]
        return srcs, masks, poses

    def forward(self, images: torch.Tensor, image_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """images (B, H, W, 3) NHWC; image_mask (B, H, W) True = padding;
        `generator` feeds dropout and the feature mask in train mode."""
        srcs, masks, poses = self.level_features(images, image_mask, generator)
        t_out = self.transformer(srcs, masks, poses, self.cls_embed,
                                 self.key_embed, self.obj_key_embed, generator)
        hs = t_out["hs"]  # (n_dec, B, Q, C)
        pose = self.mano_pose_embed[0](hs)
        beta = self.mano_beta_embed[0](hs)
        hand_cam = self.hand_cam[0](hs)
        obj_cam = self.obj_cam[0](hs)
        obj_rot = self.obj_rot[0](hs)
        obj_rad = self.obj_rad[0](hs)
        logits = t_out["pred_logits"]
        hand_key = t_out["pred_hand_key"]
        obj_key = t_out["pred_obj_key"]

        def layer_out(lvl):
            return {
                "pred_logits": logits[lvl],
                "pred_hand_key": hand_key[lvl],
                "pred_obj_key": obj_key[lvl],
                "pred_mano_params": [pose[lvl], beta[lvl]],
                "pred_obj_params": [obj_rad[lvl], obj_rot[lvl]],
                "pred_cams": [hand_cam[lvl], obj_cam[lvl]],
            }

        out = layer_out(self.num_decoder_layers - 1)
        out["aux_outputs"] = [layer_out(lvl) for lvl in range(self.num_decoder_layers - 1)]
        out["stacked"] = {
            "pred_logits": logits,
            "pred_hand_key": hand_key,
            "pred_obj_key": obj_key,
            "pred_mano_pose": pose,
            "pred_mano_beta": beta,
            "pred_hand_cam": hand_cam,
            "pred_obj_cam": obj_cam,
            "pred_obj_rot": obj_rot,
            "pred_obj_rad": obj_rad,
        }
        enc = t_out["enc_outputs"]
        out["interm_outputs"] = {
            "pred_logits": enc["pred_logits"],
            "pred_hand_key": torch.sigmoid(enc["pred_hand_key_unact"]) * 2 - 1,
            "pred_obj_key": torch.sigmoid(enc["pred_obj_key_unact"]) * 2 - 1,
        }
        return out
