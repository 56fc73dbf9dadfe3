"""Deformable transformer with 42-dim (21-keypoint) reference points: the
two-stage, box-refine path of `uvhand_tpu/models/transformer.py`.

  - encoder: MSDA self-attention over the flattened multi-scale features with
    per-level embeddings and grid reference points,
  - two-stage proposals: per-location grid + learned 40-d xy spread -> 42-d
    proposal, encoder-output class/keypoint heads, class-aware top-k with
    hand/object keypoint substitution,
  - proposal positional embedding 42x128 -> MLP(5376->1024->1024->2C) + LN,
  - decoder: MHA self-attention + MSDA cross-attention, iterative reference
    refinement gated by the per-layer argmax class (hands {12, 13}; class 0
    frozen); reference points live in [-1, 1] via `sigmoid()*2-1`, a parity
    quirk of the reference.

Eval only: there is no dropout. Parameter names follow the reference state
dict (`transformer.encoder.layers.{i}.*`, `transformer.pos_trans.{0,2,4}`...).
The class and keypoint heads belong to `UVHandDETR` (reference names
`cls_embed.{i}`, `key_embed.{i}`...) and are passed into `forward`, since the
decoder's refinement is gated on them.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.msda import MSDeformAttn
from .posenc import interleaved_sincos


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """DETR inverse_sigmoid: clamp to [0, 1] then logit."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


class MLP(nn.Module):
    """ReLU MLP with a linear last layer; reference layout `.layers.{j}`."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims, outs))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class EncoderLayer(nn.Module):
    def __init__(self, d_model=256, d_ffn=1024, n_levels=4, n_heads=8, n_points=4):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes, padding_mask):
        src2 = self.self_attn(src + pos, reference_points, src, spatial_shapes, padding_mask)
        src = self.norm1(src + src2)
        ff = self.linear2(torch.relu(self.linear1(src)))
        return self.norm2(src + ff)


class DecoderLayer(nn.Module):
    def __init__(self, d_model=256, d_ffn=1024, n_levels=4, n_heads=8, n_points=4):
        super().__init__()
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.self_attn = nn.MultiheadAttention(d_model, n_heads, batch_first=True)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes, src_padding_mask):
        q = tgt + query_pos
        tgt2 = self.self_attn(q, q, tgt, need_weights=False)[0]
        tgt = self.norm2(tgt + tgt2)
        tgt2 = self.cross_attn(tgt + query_pos, reference_points, src, spatial_shapes,
                               src_padding_mask)
        tgt = self.norm1(tgt + tgt2)
        ff = self.linear2(torch.relu(self.linear1(tgt)))
        return self.norm3(tgt + ff)


class _Layers(nn.Module):
    """`encoder` / `decoder` containers, for the reference's `.layers.{i}` names."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def encoder_reference_points(spatial_shapes, valid_ratios):
    """Grid reference points. valid_ratios (B, L, 2) -> (B, S, L, 2)."""
    dev = valid_ratios.device
    refs = []
    for lvl, (H, W) in enumerate(spatial_shapes):
        ry = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)[:, None].expand(H, W).reshape(-1)
        rx = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5)[None, :].expand(H, W).reshape(-1)
        ry = ry[None] / (valid_ratios[:, None, lvl, 1] * H)
        rx = rx[None] / (valid_ratios[:, None, lvl, 0] * W)
        refs.append(torch.stack([rx, ry], -1))
    ref = torch.cat(refs, 1)
    return ref[:, :, None] * valid_ratios[:, None]


def proposal_pos_embed(proposals: torch.Tensor, num_pos_feats: int = 128) -> torch.Tensor:
    """42-d unactivated proposal -> (B, Q, 42*num_pos_feats) sine embedding."""
    scale = 2 * math.pi
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=proposals.device)
    dim_t = 10000.0 ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    p = torch.sigmoid(proposals) * scale
    pos = interleaved_sincos(p[..., None] / dim_t)  # (B, Q, 42, F)
    return pos.flatten(2)


# sentinel for invalid two-stage proposals (sigmoid(1e4) == 1.0 in fp32)
INVALID_PROPOSAL = 1e4
HAND_CLASSES = (12, 13)  # left, right
FROZEN_CLASSES = (0,)  # argmax == 0 queries get no reference update


def _class_masks(class_indices: torch.Tensor):
    hand = torch.zeros_like(class_indices, dtype=torch.bool)
    for c in HAND_CLASSES:
        hand |= class_indices == c
    obj = ~hand
    for c in FROZEN_CLASSES + HAND_CLASSES:
        obj &= class_indices != c
    return hand, obj


class DeformableTransformer(nn.Module):
    def __init__(self, d_model=256, n_heads=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=1024, num_feature_levels=4,
                 dec_n_points=4, enc_n_points=4, num_queries=300):
        super().__init__()
        self.d_model = d_model
        self.num_queries = num_queries
        self.num_decoder_layers = num_decoder_layers
        self.encoder = _Layers(
            EncoderLayer(d_model, dim_feedforward, num_feature_levels, n_heads, enc_n_points)
            for _ in range(num_encoder_layers))
        self.decoder = _Layers(
            DecoderLayer(d_model, dim_feedforward, num_feature_levels, n_heads, dec_n_points)
            for _ in range(num_decoder_layers))
        self.level_embed = nn.Parameter(torch.zeros(num_feature_levels, d_model))
        self.enc_output = nn.Linear(d_model, d_model)
        self.enc_output_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.pos_trans = nn.Sequential(
            nn.Linear(42 * 128, 1024), nn.ReLU(),
            nn.Linear(1024, 1024), nn.ReLU(),
            nn.Linear(1024, 2 * d_model), nn.ReLU())
        self.pos_trans_norm = nn.LayerNorm(2 * d_model, eps=1e-5)
        # Embedding(1, 40), init logit(0.05)
        self.two_stage_learn_xy = nn.Embedding(1, 40)

    def _gen_proposals(self, memory, padding_mask, spatial_shapes):
        """(memory', proposals): gen_encoder_output_proposals."""
        B = memory.shape[0]
        dev = memory.device
        learn_xy = torch.sigmoid(self.two_stage_learn_xy.weight[0])  # (40,)
        props = []
        cur = 0
        for lvl, (H, W) in enumerate(spatial_shapes):
            m = padding_mask[:, cur: cur + H * W].view(B, H, W)
            valid_H = (~m[:, :, 0]).sum(1).float()
            valid_W = (~m[:, 0, :]).sum(1).float()
            gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                                    torch.arange(W, dtype=torch.float32, device=dev),
                                    indexing="ij")
            grid = torch.stack([gx, gy], -1)[None]  # (1, H, W, 2)
            scale = torch.stack([valid_W, valid_H], -1).view(B, 1, 1, 2)
            grid = (grid + 0.5) / scale  # (B, H, W, 2)
            xy = (learn_xy * (2.0 ** lvl)).expand(B, H, W, 40)
            props.append(torch.cat([grid, xy], -1).reshape(B, H * W, 42))
            cur += H * W
        proposals = torch.cat(props, 1)  # (B, S, 42)
        valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1, keepdim=True)
        proposals = torch.log(proposals / (1 - proposals))
        invalid = padding_mask[..., None] | ~valid
        proposals = proposals.masked_fill(invalid, INVALID_PROPOSAL)
        mem = memory.masked_fill(padding_mask[..., None], 0.0)
        mem = mem.masked_fill(~valid, 0.0)
        return self.enc_output_norm(self.enc_output(mem)), proposals

    def forward(
        self,
        srcs: Sequence[torch.Tensor],  # L x (B, C, H_l, W_l)
        masks: Sequence[torch.Tensor],  # L x (B, H_l, W_l) True = pad
        pos_embeds: Sequence[torch.Tensor],  # L x (B, H_l, W_l, C)
        cls_embed: nn.ModuleList,  # num_decoder_layers + 1 class heads
        key_embed: nn.ModuleList,  # hand keypoint MLPs
        obj_key_embed: nn.ModuleList,  # object keypoint MLPs
    ):
        spatial_shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
        B = srcs[0].shape[0]

        src_flat = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        mask_flat = torch.cat([m.flatten(1) for m in masks], 1)
        pos_flat = torch.cat(
            [p.flatten(1, 2) + self.level_embed[lvl][None, None]
             for lvl, p in enumerate(pos_embeds)], 1)
        valid_ratios = torch.stack(
            [torch.stack([(~m[:, 0, :]).sum(1).float() / m.shape[2],
                          (~m[:, :, 0]).sum(1).float() / m.shape[1]], -1)
             for m in masks], 1)  # (B, L, 2) = (w, h)

        # ---- encoder ----
        enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
        memory = src_flat
        for layer in self.encoder.layers:
            memory = layer(memory, pos_flat, enc_ref, spatial_shapes, mask_flat)

        # ---- two-stage decoder inputs ----
        nd = self.num_decoder_layers
        out_mem, out_props = self._gen_proposals(memory, mask_flat, spatial_shapes)
        enc_cls = cls_embed[nd](out_mem)
        enc_hand = key_embed[nd](out_mem)
        enc_obj = obj_key_embed[nd](out_mem)
        # root x added to the even dims, root y to the odd dims
        root = out_props[..., 0:2].repeat(1, 1, 21)
        enc_hand = enc_hand + root
        enc_obj = enc_obj + root

        scores = enc_cls.max(-1).values
        topk_idx = torch.topk(scores, self.num_queries, dim=1).indices  # (B, Q)

        def take(x):
            return torch.gather(x, 1, topk_idx[..., None].expand(-1, -1, x.shape[-1]))

        cls_idx = torch.gather(enc_cls.argmax(-1), 1, topk_idx)
        hand_m, obj_m = _class_masks(cls_idx)
        ref_unact = take(out_props)
        ref_unact = torch.where(obj_m[..., None], take(enc_obj), ref_unact)
        ref_unact = torch.where(hand_m[..., None], take(enc_hand), ref_unact)
        reference_points = torch.sigmoid(ref_unact) * 2 - 1  # [-1, 1] quirk

        pe = proposal_pos_embed(ref_unact)
        pt = self.pos_trans_norm(self.pos_trans(pe))
        query_pos, tgt = torch.split(pt, self.d_model, -1)

        # ---- decoder with gated reference refinement ----
        hs_list, refs_in, logits_list, hand_keys, obj_keys = [], [], [], [], []
        output = tgt
        ref = reference_points
        vr42 = valid_ratios.repeat(1, 1, 21)[:, None]  # (B, 1, L, 42)
        for lid, layer in enumerate(self.decoder.layers):
            refs_in.append(ref)
            output = layer(output, query_pos, ref[:, :, None] * vr42, memory,
                           spatial_shapes, mask_flat)
            hs_list.append(output)
            logits = cls_embed[lid](output)
            logits_list.append(logits)
            hand_m, obj_m = _class_masks(logits.argmax(-1))
            d_hand = key_embed[lid](output)
            d_obj = obj_key_embed[lid](output)
            # per-layer keypoint outputs: delta + inverse_sigmoid(ref input)
            base = inverse_sigmoid(ref)
            hand_keys.append(torch.sigmoid(d_hand + base) * 2 - 1)
            obj_keys.append(torch.sigmoid(d_obj + base) * 2 - 1)
            delta = torch.where(hand_m[..., None], d_hand,
                                torch.where(obj_m[..., None], d_obj, 0.0))
            ref = torch.sigmoid(base + delta) * 2 - 1

        return {
            "hs": torch.stack(hs_list),  # (n_dec, B, Q, C)
            "init_reference": reference_points,
            "refs_in": torch.stack(refs_in),
            "pred_logits": torch.stack(logits_list),
            "pred_hand_key": torch.stack(hand_keys),
            "pred_obj_key": torch.stack(obj_keys),
            "enc_outputs": {
                "pred_logits": enc_cls,
                "pred_hand_key_unact": enc_hand,
                "pred_obj_key_unact": enc_obj,
            },
            "memory": memory,
        }
