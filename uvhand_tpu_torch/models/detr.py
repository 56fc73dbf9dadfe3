"""UVHand DETR: backbone + deformable transformer + output heads.

Port of `uvhand_tpu/models/detr.py` for `feature_type="origin"`, the
ResNet-50, Swin-L (`backbone="swin_L_384_22k"`) or ConvNeXt-XL
(`backbone="convnext_xlarge_22k"`) backbone, the DINO variant and the
temporal heads:
  - input projections: per-level 1x1 conv + GroupNorm(32), plus an extra
    stride-2 3x3 level from the last backbone map,
  - position encoding: sine (the default) or learned
    (`position_embedding="learned"`, the reference Joiner's slot 1,
    `backbone.1.{row,col}_embed`),
  - the two-stage box-refine model (the reference's `--two_stage
    --with_box_refine`) or the single-stage one (the CLI's default): learned
    queries (`query_embed`) and a class head shared by every decoder layer
    (`with_box_refine=False`, one module registered per layer) or one per
    layer (`with_box_refine=True`); no keypoint outputs and no interm
    outputs,
  - heads per decoder layer: class and keypoints (used inside the
    transformer), mano pose 48 / beta 10, hand cam 3, obj cam 3, obj rot 3,
    obj radian 1 (the non-class heads share weights across layers),
  - two-stage per-layer 42-d keypoint outputs and the encoder's interm
    outputs in [-1, 1] via sigmoid*2-1,
  - the DINO variant (`dino_variant=True`, the CLI's `--modelname dino`):
    sine position encoding at temperature 20 without the half-cell shift,
    one class head and one pair of keypoint MLPs tied across the decoder
    layers (the reference's `class_embed.{i}`, `key_embed.{i}`,
    `obj_key_embed.{i}`, each the same module; the keypoint MLPs' last
    layers start at zero), the encoder output's own heads, learned content
    queries and per-layer query positions in the transformer;
  - contrastive denoising (`use_dn`, on with the DINO variant; the
    reference's CDN): in train mode, given `dn_targets` (or an injected
    `dn_meta`), `models/dn.py` builds `2 x 3 x groups` noised queries from
    the targets (drawn from the `generator`), `label_enc` embeds their
    labels, and they go through the decoder ahead of the matching queries
    under the CDN attention mask; their part of every head is split off
    into `out["dn_outputs"]` with the `dn_meta` that made them. With
    `look_forward_twice` (the CLI sets it with `use_dn`) each layer's
    keypoint outputs stand on the undetached references of the layer
    before,
  - a temporal head (`temporal_head="lstm"` or `"vivit"`, the CLI's
    `--method arctic_lstm --temporal_head`; `models/temporal/sequence.py`)
    refines the last layer's selected parameters over each window of
    `temporal_window` consecutive rows (the window collates' layout) into
    `out["temporal_selected"]`, which the criterion supervises (`/temporal`
    terms) and the eval steps decode,
  - `aux_loss=False` drops the `aux_outputs` key only, as the JAX model
    does: `stacked` keeps every layer, and the criterion reads that,
  - train mode (`model.train()`): dropout in the transformer and the
    encoder feature mask (each input-projected element kept with
    probability 1 - feature_mask_ratio, with no rescale), both drawn from
    the `torch.Generator` passed to `forward`; `remat` and `enc_lite` as in
    the transformer,
  - `compute_dtype` (the JAX model's bf16 compute mode): the backbone and
    the transformer compute in it where the JAX model does; the input
    projections and heads compute in the promoted type of their input and
    parameters (`layers.py`), so with float32 parameters they are float32.
    `param_dtype=torch.bfloat16` stores every parameter in bfloat16 (the JAX
    package's `--bf16_params`, used with `compute_dtype=torch.bfloat16`).

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
from .backbones import convnext, swin
from .backbones.resnet import RESNET50_CHANNELS, ResNet50
from .dn import CdnConfig, cdn_attn_mask, prepare_cdn
from .layers import Conv2d, GroupNorm, Linear
from ..losses.criterion import select_queries
from .posenc import LearnedPositionEncoding, sine_position_encoding
from .temporal.sequence import BLOCKS as TEMPORAL_HEADS
from .temporal.sequence import TemporalParamHead
from .transformer import MLP, DeformableTransformer, keep_mask

BACKBONES = ("resnet50", "swin_L_384_22k", "convnext_xlarge_22k")


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
        conv = (Conv2d(cin, d_model, 3, stride=2, padding=1) if extra_level
                else Conv2d(cin, d_model, 1))
        super().__init__(conv, GroupNorm(32, d_model, eps=1e-5))


class _Joiner0(nn.Module):
    """Slot 0 of the reference's `Joiner(backbone, position_embedding)`:
    keeps the ResNet under `.body` for the `backbone.0.body.*` names."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.body = ResNet50(dtype=dtype)


class UVHandDETR(nn.Module):
    def __init__(self, num_classes: int = 14, num_queries: int = 300,
                 d_model: int = 256, n_heads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 1024, num_feature_levels: int = 4,
                 dec_n_points: int = 4, enc_n_points: int = 4,
                 dropout: float = 0.1, feature_mask_ratio: float = 0.3,
                 two_stage: bool = True, with_box_refine: bool = True,
                 aux_loss: bool = True, position_embedding: str = "sine",
                 enc_lite: bool = False, enc_lite_hi_every: int = 3, remat: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, backbone: str = "resnet50",
                 use_dn: bool = False, dino_variant: bool = False, dn_number: int = 100,
                 dn_label_noise_ratio: float = 0.5, dn_box_noise_scale: float = 1.0,
                 look_forward_twice: bool = False, temporal_head: str = "none",
                 temporal_window: int = 0,
                 generator: torch.Generator | None = None, device=None):
        """Builds the model with weights drawn from `generator` on `device`
        (the CUDA card unless `device="cpu"` is given), in eval mode.
        Raises ValueError on a combination the JAX model cannot build
        (`two_stage=True, with_box_refine=False` but for the DINO variant;
        the DINO variant or `use_dn` without `two_stage`), and on an unknown
        `temporal_head` or one with a `temporal_window` below 2."""
        super().__init__()
        if temporal_head != "none" and temporal_head not in TEMPORAL_HEADS:
            raise ValueError(f"unknown temporal_head {temporal_head!r}: none, lstm or vivit")
        if temporal_head != "none" and temporal_window <= 1:
            raise ValueError(f"temporal_head {temporal_head!r} needs temporal_window > 1, "
                             f"got {temporal_window}")
        if position_embedding not in ("sine", "learned"):
            raise ValueError(f"unknown position_embedding {position_embedding!r}")
        if backbone not in BACKBONES:
            raise ValueError(f"unknown backbone {backbone!r}")
        if use_dn and not two_stage:
            # the JAX model embeds the dn query positions with the two-stage
            # pos_trans MLP, which the single-stage model lacks
            raise ValueError("use_dn=True with two_stage=False: the JAX model fails to train "
                             "this combination (no pos_trans for the dn queries)")
        device = resolve_device(device)
        self.d_model = d_model
        self.num_classes = num_classes
        self.num_queries = num_queries
        self.feature_mask_ratio = feature_mask_ratio
        self.num_decoder_layers = num_decoder_layers
        self.num_feature_levels = num_feature_levels
        self.two_stage = two_stage
        self.aux_loss = aux_loss
        self.dino = dino_variant
        self.use_dn = use_dn
        self.cdn = CdnConfig(dn_number, dn_label_noise_ratio, dn_box_noise_scale)
        # the reference's Joiner(backbone, position_embedding): the learned
        # embedding's parameters sit in its slot 1; the ResNet sits under
        # slot 0's `.body`, the Swin and the ConvNeXt in slot 0 itself
        if backbone == "resnet50":
            body, channels = _Joiner0(compute_dtype), RESNET50_CHANNELS
        elif backbone == "swin_L_384_22k":
            # drop_path_rate 0.2, the JAX module's default, whatever the flags
            # say; it never runs here (`level_features`)
            body = swin.SwinTransformer.swin_l_384(dtype=compute_dtype)
            channels = swin.SWIN_L_CHANNELS
        else:
            body = convnext.ConvNeXt(convnext.CONVNEXT_XL_DEPTHS, convnext.CONVNEXT_XL_DIMS,
                                     dtype=compute_dtype)
            channels = body.channels
        self.backbone = nn.ModuleList(
            [body] + ([LearnedPositionEncoding(d_model // 2)] if position_embedding == "learned"
                      else []))
        nb = len(channels)
        self.input_proj = nn.ModuleList(
            [InputProj(c, d_model) for c in channels]
            + [InputProj(channels[-1] if i == nb else d_model, d_model, extra_level=True)
               for i in range(nb, num_feature_levels)])
        self.transformer = DeformableTransformer(
            d_model=d_model, n_heads=n_heads,
            num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers,
            dim_feedforward=dim_feedforward,
            num_feature_levels=num_feature_levels,
            dec_n_points=dec_n_points, enc_n_points=enc_n_points,
            num_queries=num_queries, dropout=dropout, two_stage=two_stage,
            with_box_refine=with_box_refine, enc_lite=enc_lite,
            enc_lite_hi_every=enc_lite_hi_every, remat=remat, compute_dtype=compute_dtype,
            dino_variant=dino_variant, look_forward_twice=look_forward_twice,
            num_classes=num_classes)
        if not two_stage:
            self.query_embed = nn.Embedding(num_queries, 2 * d_model)
        if use_dn:
            # the dn labels' embedding: num_classes + 1 rows, as the JAX
            # model's (which creates it lazily; here it is built with the rest)
            self.label_enc = nn.Embedding(num_classes + 1, d_model)
        # two-stage: the extra class and keypoint heads are the encoder's
        # (the DINO variant's encoder heads are the transformer's own)
        num_pred = num_decoder_layers + 1 if two_stage and not dino_variant else num_decoder_layers
        if dino_variant:
            # ONE class head and ONE pair of keypoint MLPs, registered once
            # per decoder layer under the reference DINO names
            self.class_embed = nn.ModuleList([Linear(d_model, num_classes)] * num_pred)
        elif with_box_refine:
            self.cls_embed = nn.ModuleList(Linear(d_model, num_classes) for _ in range(num_pred))
        else:  # the reference registers ONE class head num_pred times
            self.cls_embed = nn.ModuleList([Linear(d_model, num_classes)] * num_pred)
        # keypoint heads only where the JAX model calls them (the refinement
        # of the two-stage box-refine model); it has no parameters elsewhere
        self.key_embed = self.obj_key_embed = None
        if dino_variant:
            self.key_embed = nn.ModuleList([MLP(d_model, d_model, 42, 3)] * num_pred)
            self.obj_key_embed = nn.ModuleList([MLP(d_model, d_model, 42, 3)] * num_pred)
        elif self.transformer.refine:
            self.key_embed = nn.ModuleList(MLP(d_model, d_model, 42, 3) for _ in range(num_pred))
            self.obj_key_embed = nn.ModuleList(MLP(d_model, d_model, 42, 3)
                                               for _ in range(num_pred))
        # the reference registers ONE module per output head num_pred times
        for name, dout in (("mano_pose_embed", 48), ("mano_beta_embed", 10),
                           ("hand_cam", 3), ("obj_cam", 3), ("obj_rot", 3),
                           ("obj_rad", 1)):
            setattr(self, name, nn.ModuleList([Linear(d_model, dout)] * num_pred))
        # the JAX model's head is 256 wide whatever d_model is
        self.temporal_param_head = (None if temporal_head == "none"
                                    else TemporalParamHead(temporal_window, kind=temporal_head))
        self.reset_parameters(generator)
        self.to(device=device, dtype=param_dtype)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Random weights from `generator`: xavier-uniform linears and convs
        with zero biases, the MSDA offset/attention init, level embeddings,
        learned queries, the DINO content queries and the dn label
        embedding ~ N(0, 1), learned position embeddings ~ U(0, 1), the
        focal-loss prior on the class biases, the two-stage xy spread at
        logit(0.05), in the DINO variant zero last layers of the keypoint
        MLPs, and the temporal head's own draws (`TemporalParamHead.
        reset_parameters`: its `out_proj`s zero)."""
        for mod in self.modules():
            # (the backbone's bias-free convs are drawn by its own reset below)
            if isinstance(mod, (nn.Linear, nn.Conv2d)) and mod.bias is not None:
                nn.init.xavier_uniform_(mod.weight, generator=generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.MultiheadAttention):
                nn.init.xavier_uniform_(mod.in_proj_weight, generator=generator)
                nn.init.zeros_(mod.in_proj_bias)
        self.body.reset_parameters(generator)
        for mod in self.modules():
            if isinstance(mod, MSDeformAttn):
                mod.reset_parameters(generator)
        t = self.transformer
        t.level_embed.normal_(0.0, 1.0, generator=generator)
        if self.two_stage:
            t.learn_xy.weight.fill_(math.log(0.05 / (1 - 0.05)))
        else:
            self.query_embed.weight.normal_(0.0, 1.0, generator=generator)
        if self.dino:
            t.tgt_embed.weight.normal_(0.0, 1.0, generator=generator)
        if self.use_dn:
            self.label_enc.weight.normal_(0.0, 1.0, generator=generator)
        if len(self.backbone) > 1:
            self.backbone[1].reset_parameters(generator)
        prior = -math.log((1 - 0.01) / 0.01)
        for head in self.cls_heads:
            head.bias.fill_(prior)
        if self.dino:
            t.enc_out_class_embed.bias.fill_(prior)
            for mlp in (self.key_embed[0], self.obj_key_embed[0], t.enc_out_key_embed,
                        t.enc_out_obj_key_embed):
                mlp.layers[-1].weight.zero_()
        if self.temporal_param_head is not None:
            self.temporal_param_head.reset_parameters(generator)

    @property
    def body(self) -> nn.Module:
        """The backbone network: the ResNet under the Joiner's slot 0, or the
        Swin or the ConvNeXt in it."""
        slot = self.backbone[0]
        return slot.body if isinstance(slot, _Joiner0) else slot

    @property
    def cls_heads(self) -> nn.ModuleList:
        """The class heads, one per decoder layer (+1 for the two-stage
        encoder but in the DINO variant), under the reference's name."""
        return self.class_embed if self.dino else self.cls_embed

    def _feature_mask(self, x: torch.Tensor, generator: torch.Generator | None):
        if not self.training or self.feature_mask_ratio <= 0:
            return x
        # the reference applies no 1/keep rescale
        return x * keep_mask(x.shape, 1.0 - self.feature_mask_ratio, generator, x.device)

    def level_features(self, images: torch.Tensor, image_mask: torch.Tensor | None = None,
                       generator: torch.Generator | None = None):
        """(srcs (B, C, H_l, W_l), masks (B, H_l, W_l), pos (B, H_l, W_l, C))
        for every level, from NHWC images."""
        # the input projections promote the compute-type maps to their
        # parameters' type, as flax does. The JAX model calls its backbone
        # in eval mode, so the Swin's stochastic depth never runs here
        feats = self.body(images.permute(0, 3, 1, 2))
        B, H, W, _ = images.shape
        if image_mask is None:
            image_mask = torch.zeros(B, H, W, dtype=torch.bool, device=images.device)
        srcs = [self._feature_mask(proj(f), generator) for proj, f in zip(self.input_proj, feats)]
        for lvl in range(len(feats), self.num_feature_levels):
            src = self.input_proj[lvl](feats[-1] if lvl == len(feats) else srcs[-1])
            srcs.append(self._feature_mask(src, generator))
        masks = [resize_mask(image_mask, s.shape[-2:]) for s in srcs]
        if len(self.backbone) > 1:
            poses = [self.backbone[1](m) for m in masks]
        elif self.dino:  # PositionEmbeddingSineHW: temperature 20, no half-cell shift
            poses = [sine_position_encoding(m, self.d_model // 2, temperature=20.0,
                                            center_shift=False) for m in masks]
        else:
            poses = [sine_position_encoding(m, self.d_model // 2) for m in masks]
        return srcs, masks, poses

    def forward(self, images: torch.Tensor, image_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None, dn_targets: dict | None = None,
                dn_meta: dict | None = None):
        """images (B, H, W, 3) NHWC; image_mask (B, H, W) True = padding;
        `generator` feeds dropout, the feature mask and the CDN draws in
        train mode. With `use_dn`, in train mode, `dn_targets` ({"labels",
        "keypoints", "target_valid"} of the batch) gives the CDN queries,
        drawn from `generator`; a given `dn_meta` (`models/dn.py::
        noise_cdn`'s dict) replaces the draw."""
        srcs, masks, poses = self.level_features(images, image_mask, generator)
        dn = None
        if self.use_dn and self.training and (dn_targets is not None or dn_meta is not None):
            if dn_meta is None:
                dn_meta = prepare_cdn(generator, dn_targets["labels"], dn_targets["keypoints"],
                                      dn_targets["target_valid"], self.num_classes, self.cdn)
            dn = (self.label_enc(dn_meta["dn_labels_noised"]), dn_meta["dn_keys_unact"],
                  cdn_attn_mask(self.num_queries, self.cdn, images.device))
        t_out = self.transformer(
            srcs, masks, poses, self.cls_heads, self.key_embed, self.obj_key_embed, generator,
            query_embed=None if self.two_stage else self.query_embed.weight, dn=dn)
        hs = t_out["hs"]  # (n_dec, B, P + Q, C)
        logits = t_out["pred_logits"].float()
        hand_key = t_out["pred_hand_key"]
        obj_key = t_out["pred_obj_key"]
        num_dn = t_out["num_dn"]
        dn_out = None
        if num_dn:
            # the dn part of every head, split off
            dn_out = {
                "pred_logits": logits[:, :, :num_dn],
                "pred_hand_key": None if hand_key is None else hand_key[:, :, :num_dn],
                "pred_obj_key": None if obj_key is None else obj_key[:, :, :num_dn],
                "dn_meta": dn_meta,
            }
            hs, logits = hs[:, :, num_dn:], logits[:, :, num_dn:]
            if hand_key is not None:
                hand_key, obj_key = hand_key[:, :, num_dn:], obj_key[:, :, num_dn:]
        pose = self.mano_pose_embed[0](hs)
        beta = self.mano_beta_embed[0](hs)
        hand_cam = self.hand_cam[0](hs)
        obj_cam = self.obj_cam[0](hs)
        obj_rot = self.obj_rot[0](hs)
        obj_rad = self.obj_rad[0](hs)

        def layer_out(lvl):
            return {
                "pred_logits": logits[lvl],
                "pred_hand_key": None if hand_key is None else hand_key[lvl],
                "pred_obj_key": None if obj_key is None else obj_key[lvl],
                "pred_mano_params": [pose[lvl], beta[lvl]],
                "pred_obj_params": [obj_rad[lvl], obj_rot[lvl]],
                "pred_cams": [hand_cam[lvl], obj_cam[lvl]],
            }

        out = layer_out(self.num_decoder_layers - 1)
        if self.aux_loss:
            out["aux_outputs"] = [layer_out(lvl) for lvl in range(self.num_decoder_layers - 1)]
        # every layer, with or without aux_loss: the criterion reads these
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
        if enc is not None:
            out["interm_outputs"] = {
                "pred_logits": enc["pred_logits"],
                "pred_hand_key": torch.sigmoid(enc["pred_hand_key_unact"]) * 2 - 1,
                "pred_obj_key": torch.sigmoid(enc["pred_obj_key_unact"]) * 2 - 1,
            }
        if dn_out is not None:
            out["dn_outputs"] = dn_out
        if self.temporal_param_head is not None:
            last = {k: v[-1] for k, v in out["stacked"].items() if v is not None}
            out["temporal_selected"] = self.temporal_param_head(select_queries(last))
        return out
