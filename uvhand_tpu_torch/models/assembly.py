"""The AssemblyHands / H2O / FPHA 2.5D keypoint DETR.

Port of `uvhand_tpu/models/assembly.py` (the reference's
`models/assembly_detr.py` and `assembly_transformer.py` in the two-stage
box-refine configuration, the one the JAX package builds): per query a
63-d (21 x (u, v, d)) keypoint MLP head, two-stage proposals from the LAST
feature level only with 2-d grid proposals, and three decoder queries
chosen class-aware from the encoder's outputs:
  - the object query is the best query of classes 1..8 by the reference's
    loop: the best score starts at 0 and changes only on a strict
    improvement, class by class (so with every logit negative, as under the
    focal bias init, it stays query 0); the hands are the argmax of columns
    9 (left) and 10 (right); the queries go in (left, right, object) order;
  - the decoder's first layer takes 2-d references (the mean of each
    selected proposal's sigmoided u and v), every later one 42-d references
    in [-0.5, 1.5], which the deformable cross-attention's center-refine
    branch means back to a 2-d center;
  - the output head adds each layer's delta to a base from the layer's
    input reference (per point invsig((ref + 0.5) / 2), then the mean),
    to every query, and squashes the whole 63-d vector by sigmoid*2 - 0.5;
  - the in-decoder refinement takes its base the other way round (the mean,
    then (x + 0.5) / 2, then invsig) and adds the uv delta only to queries
    whose argmax class is not 0;
  - the selected proposals, the refined references and the matcher's
    assignments carry no gradient.

The model ignores the width, head, dropout, query and backbone options of
the CLI and always runs 8 heads, FFN 1024, dropout 0.1, 3 queries, the
ResNet-50 and float32, as the JAX model does. Parameter names are the
reference's (`backbone.0.body.*`, `input_proj.{i}`,
`transformer.{level_embed, encoder.layers.{i}, decoder.layers.{i},
enc_output, enc_output_norm}`, `query_embed`, `cls_embed.{i}`,
`keypoint_embed.{i}`, and `obj_keypoint_embed.{n}` for the encoder's object
head only: the decoder layers' clones are never called, and the JAX tree has
none). In train mode (`model.train()`) dropout draws from the
`torch.Generator` passed to `forward`.

`assembly_match` and `assembly_criterion` are the reference's
`AssemblyMatcher` and `SetAssemblyCriterion`: the focal class cost plus the
63-d keypoint L1, assigned exactly per image (`losses/matching.py::
hungarian_small`), every decoder layer rematched; the sigmoid focal CE over
all queries (unmatched ones are background) normalised by `num_boxes` times
Q, and the keypoint L1 over matched hand slots only, summed and divided by
21; `cardinality_error` is logged and carries no gradient.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..losses.matching import hungarian_small
from ..ops.msda import MSDeformAttn
from .detr import InputProj, _Joiner0
from .backbones.resnet import RESNET50_CHANNELS
from .layers import LayerNorm, Linear
from .posenc import sine_position_encoding
from .transformer import (MLP, DecoderLayer, EncoderLayer, _Layers, encoder_reference_points,
                          inverse_sigmoid)

NUM_QUERIES = 3  # left hand, right hand, object


class AssemblyTransformer(nn.Module):
    def __init__(self, d_model: int = 256, n_heads: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, dim_feedforward: int = 1024,
                 dropout: float = 0.1, num_feature_levels: int = 4,
                 num_obj_classes: int = 8):
        super().__init__()
        self.d_model = d_model
        self.num_obj_classes = num_obj_classes
        self.num_decoder_layers = num_decoder_layers
        self.encoder = _Layers(
            EncoderLayer(d_model, dim_feedforward, num_feature_levels, n_heads, 4, dropout)
            for _ in range(num_encoder_layers))
        self.decoder = _Layers(
            DecoderLayer(d_model, dim_feedforward, num_feature_levels, n_heads, 4, dropout)
            for _ in range(num_decoder_layers))
        self.level_embed = nn.Parameter(torch.zeros(num_feature_levels, d_model))
        self.enc_output = Linear(d_model, d_model)
        self.enc_output_norm = LayerNorm(d_model, eps=1e-5)

    def select(self, enc_cls: torch.Tensor) -> tuple:
        """(left, right, object) query indices (B,) each from the encoder's
        logits (B, S, C): the reference's strict-improvement loop from a
        best score of 0 over classes 1..num_obj_classes, then the argmax of
        the two hand columns."""
        B = enc_cls.shape[0]
        best_score = torch.zeros(B, dtype=enc_cls.dtype, device=enc_cls.device)
        best_q = torch.zeros(B, dtype=torch.long, device=enc_cls.device)
        for c in range(1, 1 + self.num_obj_classes):
            score = enc_cls[:, :, c].amax(1)
            idx = enc_cls[:, :, c].argmax(1)  # the first of equal maxima, as jnp.argmax
            take = best_score < score
            best_q = torch.where(take, idx, best_q)
            best_score = torch.where(take, score, best_score)
        left = enc_cls[:, :, self.num_obj_classes + 1].argmax(1)
        right = enc_cls[:, :, self.num_obj_classes + 2].argmax(1)
        return left, right, best_q

    def forward(self, srcs, masks, pos_embeds, cls_embed: nn.ModuleList,
                keypoint_embed: nn.ModuleList, obj_keypoint_embed: nn.Module,
                query_embed: torch.Tensor, generator: torch.Generator | None = None):
        """srcs L x (B, C, H_l, W_l), masks L x (B, H_l, W_l), pos_embeds
        L x (B, H_l, W_l, C); the heads of `AssemblyDETR`; query_embed
        (3, 2C)."""
        spatial_shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
        B = srcs[0].shape[0]
        dev = srcs[0].device
        src_flat = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        mask_flat = torch.cat([m.flatten(1) for m in masks], 1)
        pos_flat = torch.cat([p.flatten(1, 2) + self.level_embed[lvl][None, None]
                              for lvl, p in enumerate(pos_embeds)], 1)
        valid_ratios = torch.ones(B, len(srcs), 2, device=dev)

        memory = src_flat
        enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
        for layer in self.encoder.layers:
            memory = layer(memory, pos_flat, enc_ref, spatial_shapes, mask_flat, generator)

        # two-stage on the last level only, with 2-d grid proposals
        Hl, Wl = spatial_shapes[-1]
        out_mem = self.enc_output_norm(self.enc_output(memory[:, -Hl * Wl:]))
        gy, gx = torch.meshgrid(torch.arange(Hl, dtype=torch.float32, device=dev),
                                torch.arange(Wl, dtype=torch.float32, device=dev),
                                indexing="ij")
        grid = torch.stack([(gx + 0.5) / Wl, (gy + 0.5) / Hl], -1).reshape(1, -1, 2)
        proposals = torch.log(grid / (1 - grid))  # (1, Hl*Wl, 2)
        nd = self.num_decoder_layers
        enc_cls = cls_embed[nd](out_mem)
        # x added to the u columns, y to the v columns
        root = F.pad(proposals, (0, 1)).repeat(1, 1, 21)  # (1, S, 63): (x, y, 0) per point
        enc_hand = keypoint_embed[nd](out_mem) + root
        enc_obj = obj_keypoint_embed[str(nd)](out_mem) + root

        left, right, obj = self.select(enc_cls)
        b = torch.arange(B, device=dev)
        sel = torch.stack([enc_hand[b, left], enc_hand[b, right], enc_obj[b, obj]], 1).detach()
        ref = torch.sigmoid(sel)
        ref2 = torch.stack([ref[..., 0::3].mean(-1), ref[..., 1::3].mean(-1)], -1)  # (B, 3, 2)

        query_pos, tgt = torch.split(query_embed, self.d_model, -1)
        query_pos = query_pos[None].expand(B, -1, -1)
        output = tgt[None].expand(B, -1, -1)
        hs_list, logits_list, keys_list = [], [], []
        ref42 = None  # (B, 3, 42): the running per-point reference after layer 0
        for lid, layer in enumerate(self.decoder.layers):
            if lid == 0:
                ref_in = ref2[:, :, None] * valid_ratios[:, None]  # (B, 3, L, 2)
            else:
                ref_in = ref42[:, :, None] * valid_ratios.repeat(1, 1, 21)[:, None]
            output = layer(output, query_pos, ref_in, memory, spatial_shapes, mask_flat,
                           generator)
            hs_list.append(output)
            logits = cls_embed[lid](output)
            logits_list.append(logits)
            hand = logits.argmax(-1) != 0  # (B, 3)
            delta = keypoint_embed[lid](output).reshape(B, 3, 21, 3)

            # the output head: per point invsig((ref + 0.5) / 2), then the mean
            if lid == 0:
                out_base = inverse_sigmoid(ref2)
            else:
                out_base = inverse_sigmoid((ref42 + 0.5) / 2).reshape(B, 3, 21, 2).mean(2)
            key63 = torch.cat([delta[..., :2] + out_base[:, :, None], delta[..., 2:]], -1)
            keys_list.append(torch.sigmoid(key63.reshape(B, 3, 63)) * 2 - 0.5)

            # the refinement: the mean, then (x + 0.5) / 2, then invsig; the
            # uv delta on hand queries only
            if lid == 0:
                ref_base = inverse_sigmoid(ref2)
            else:
                mean42 = torch.stack([ref42[..., 0::2].mean(-1), ref42[..., 1::2].mean(-1)], -1)
                ref_base = inverse_sigmoid((mean42 + 0.5) / 2)
            new42 = ref_base[:, :, None, :] + torch.where(hand[:, :, None, None], delta[..., :2],
                                                          0.0)
            ref42 = (torch.sigmoid(new42.reshape(B, 3, 42)) * 2 - 0.5).detach()

        return {
            "hs": torch.stack(hs_list),
            "pred_logits": torch.stack(logits_list),
            "pred_keypoints": torch.stack(keys_list),  # (L, B, 3, 63)
            "enc_outputs": {"pred_logits": enc_cls, "pred_keypoints": torch.sigmoid(enc_hand)},
        }


class AssemblyDETR(nn.Module):
    def __init__(self, num_classes: int = 12, num_feature_levels: int = 4, d_model: int = 256,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 generator: torch.Generator | None = None, device=None):
        """Builds the model with weights drawn from `generator` on `device`
        (the CUDA card unless `device="cpu"` is given), in eval mode."""
        super().__init__()
        device = resolve_device(device)
        self.d_model = d_model
        self.num_classes = num_classes
        self.num_feature_levels = num_feature_levels
        self.num_decoder_layers = num_decoder_layers
        self.backbone = nn.ModuleList([_Joiner0()])
        nb = len(RESNET50_CHANNELS)
        self.input_proj = nn.ModuleList(
            [InputProj(c, d_model) for c in RESNET50_CHANNELS]
            + [InputProj(RESNET50_CHANNELS[-1] if i == nb else d_model, d_model,
                         extra_level=True) for i in range(nb, num_feature_levels)])
        self.transformer = AssemblyTransformer(
            d_model=d_model, num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers, num_feature_levels=num_feature_levels)
        num_pred = num_decoder_layers + 1
        self.query_embed = nn.Embedding(NUM_QUERIES, 2 * d_model)
        self.cls_embed = nn.ModuleList(Linear(d_model, num_classes) for _ in range(num_pred))
        self.keypoint_embed = nn.ModuleList(MLP(d_model, d_model, 63, 3)
                                            for _ in range(num_pred))
        self.obj_keypoint_embed = nn.ModuleDict({str(num_decoder_layers):
                                                 MLP(d_model, d_model, 63, 3)})
        self.reset_parameters(generator)
        self.to(device)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Random weights from `generator`: xavier-uniform linears and convs
        with zero biases, the MSDA offset/attention init, the ResNet's own,
        level embeddings and queries ~ N(0, 1), the focal-loss prior on the
        class biases."""
        for mod in self.modules():
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
        self.query_embed.weight.normal_(0.0, 1.0, generator=generator)
        prior = -math.log((1 - 0.01) / 0.01)
        for head in self.cls_embed:
            head.bias.fill_(prior)

    def forward(self, images: torch.Tensor, generator: torch.Generator | None = None):
        """images (B, H, W, 3) NHWC; `generator` feeds dropout in train mode."""
        feats = self.backbone[0].body(images.permute(0, 3, 1, 2))
        srcs = [proj(f) for proj, f in zip(self.input_proj, feats)]
        for lvl in range(len(feats), self.num_feature_levels):
            srcs.append(self.input_proj[lvl](feats[-1] if lvl == len(feats) else srcs[-1]))
        masks = [torch.zeros(s.shape[0], *s.shape[2:], dtype=torch.bool, device=s.device)
                 for s in srcs]
        poses = [sine_position_encoding(m, self.d_model // 2) for m in masks]
        t = self.transformer(srcs, masks, poses, self.cls_embed, self.keypoint_embed,
                             self.obj_keypoint_embed, self.query_embed.weight, generator)
        n = t["pred_logits"].shape[0]
        return {
            "pred_logits": t["pred_logits"][-1],
            "pred_keypoints": t["pred_keypoints"][-1],
            "aux_outputs": [{"pred_logits": t["pred_logits"][lvl],
                             "pred_keypoints": t["pred_keypoints"][lvl]} for lvl in range(n - 1)],
            "stacked": t,
        }


def assembly_match(logits, keys, tgt_labels, tgt_keypoints63, target_valid,
                   cost_class: float = 2.0, cost_keypoint: float = 5.0) -> torch.Tensor:
    """The focal class cost at the target labels plus the 63-d keypoint L1,
    assigned exactly per image: (B, T) query per target, -1 for an invalid
    one."""
    prob = torch.sigmoid(logits)
    alpha, gamma = 0.25, 2.0
    neg = (1 - alpha) * prob ** gamma * (-torch.log(1 - prob + 1e-8))
    pos = alpha * (1 - prob) ** gamma * (-torch.log(prob + 1e-8))
    lab = tgt_labels.clamp(min=0).long()
    B, Q = logits.shape[:2]
    cls_cost = torch.gather(pos - neg, 2, lab[:, None, :].expand(B, Q, -1))
    kp_cost = (keys[:, :, None] - tgt_keypoints63[:, None]).abs().sum(-1)
    return hungarian_small(cost_class * cls_cost + cost_keypoint * kp_cost, target_valid)


def assembly_criterion(outputs, tgt_labels, tgt_keypoints63, target_valid, joint_valid63=None,
                       hand_ids=(9, 10), num_classes: int = 12, set_cost_class: float = 1.5,
                       set_cost_keypoint: float = 4.0, cls_coef: float = 2.0,
                       keypoint_coef: float = 5.0, num_boxes: torch.Tensor | None = None):
    """(total, {"loss_ce", "loss_keypoint", "cardinality_error", "total"}),
    the first three of the last layer, `total` the weighted sum over every
    layer. `joint_valid63` (B, T, 63) bool masks joints (default all);
    `num_boxes` replaces the batch's count of valid targets (the global
    batch's, over several processes)."""
    st = outputs["stacked"]
    logits_all, keys_all = st["pred_logits"], st["pred_keypoints"]
    L, B, Q, C = logits_all.shape
    if joint_valid63 is None:
        joint_valid63 = torch.ones_like(tgt_keypoints63, dtype=torch.bool)
    if num_boxes is None:
        num_boxes = target_valid.sum().float()
    num_boxes = num_boxes.clamp(min=1.0)
    hand_rows = torch.zeros_like(target_valid)
    for h in hand_ids:
        hand_rows = hand_rows | (tgt_labels == h)
    hand_rows = hand_rows & target_valid
    tgt_len = target_valid.sum(1).float()
    q_range = torch.arange(Q, device=logits_all.device)[None]
    b_idx = torch.arange(B, device=logits_all.device)[:, None]
    ces, kps, cards = [], [], []
    for logits, keys in zip(logits_all, keys_all):
        with torch.no_grad():
            assign = assembly_match(logits, keys, tgt_labels, tgt_keypoints63, target_valid,
                                    set_cost_class, set_cost_keypoint)
        tc = torch.full((B, Q), C, dtype=torch.long, device=logits.device)
        for t in range(tgt_labels.shape[1]):
            a = assign[:, t:t + 1]
            hit = (q_range == a) & (a >= 0)
            tc = torch.where(hit, tgt_labels[:, t:t + 1].clamp(min=0).long(), tc)
        onehot = F.one_hot(tc, C + 1)[..., :-1].to(logits.dtype)
        p = torch.sigmoid(logits)
        ce = logits.clamp(min=0) - logits * onehot + torch.log1p(torch.exp(-logits.abs()))
        p_t = p * onehot + (1 - p) * (1 - onehot)
        loss = (0.25 * onehot + 0.75 * (1 - onehot)) * ce * (1 - p_t) ** 2
        ces.append(loss.mean(1).sum() / num_boxes * Q)
        src = keys[b_idx, assign.clamp(min=0)]  # (B, T, 63)
        sel = hand_rows & (assign >= 0)
        l1 = (src - tgt_keypoints63).abs() * joint_valid63
        kps.append((l1 * sel[..., None]).sum() / 21.0)
        with torch.no_grad():
            card_pred = (logits.argmax(-1) != C - 1).sum(1).float()
            cards.append((card_pred - tgt_len).abs().mean())
    total = cls_coef * torch.stack(ces).sum() + keypoint_coef * torch.stack(kps).sum()
    return total, {"loss_ce": ces[-1], "loss_keypoint": kps[-1],
                   "cardinality_error": cards[-1], "total": total}


def select_slots(logits: torch.Tensor, keys: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The eval step's prediction of each GT slot: the keypoints (B, T, 63)
    of the query with the highest probability of that slot's label
    (labels (B, T), -1 read as 0)."""
    prob = torch.sigmoid(logits)  # (B, Q, C)
    lab = labels.clamp(min=0).long()
    per_slot = torch.gather(prob.transpose(1, 2), 1,
                            lab[:, :, None].expand(-1, -1, prob.shape[1]))  # (B, T, Q)
    q = per_slot.argmax(-1)
    return torch.gather(keys, 1, q[..., None].expand(-1, -1, keys.shape[-1]))
