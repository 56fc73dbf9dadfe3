"""Deformable transformer with 42-dim (21-keypoint) reference points, as
`uvhand_tpu/models/transformer.py` builds it:

  - encoder: MSDA self-attention over the flattened multi-scale features with
    per-level embeddings and grid reference points; with `enc_lite` (the JAX
    package's Lite-DETR mode) most layers refine only the low-resolution
    tokens (levels 1.., the tail of the sequence), which still sample the
    whole, partially updated memory, and every `enc_lite_hi_every`-th layer
    and the last refine them all,
  - single stage (`two_stage=False`): learned queries (`query_embed`, split
    into query position and content) and 2-d reference points
    `sigmoid(reference_points(query_pos))`, no refinement and no keypoint
    outputs,
  - two-stage proposals: per-location grid + learned 40-d xy spread -> 42-d
    proposal, encoder-output class/keypoint heads, class-aware top-k with
    hand/object keypoint substitution,
  - proposal positional embedding 42x128 -> MLP(5376->1024->1024->2C) + LN,
  - decoder: MHA self-attention + MSDA cross-attention, iterative reference
    refinement gated by the per-layer argmax class (hands {12, 13}; class 0
    frozen) in the two-stage box-refine model; reference points live in
    [-1, 1] via `sigmoid()*2-1`, a parity quirk of the reference,
  - the DINO variant (`dino_variant`): learned content queries
    (`tgt_embed`), a per-layer query position (`decoder.ref_point_head` of
    `sine_embed_42` of the layer's level-0 reference input), a norm on every
    decoder output (`decoder.norm`; the refinement reads the raw output,
    the reported logits and keypoints the normed one), the encoder output's
    own heads (`enc_out_*`), proposals added per dimension, and interm
    keys detached and hand/object swapped, as the JAX model has them,
  - contrastive denoising (`dn`): the CDN queries' content and references
    go ahead of the matching queries, the decoder self-attention under the
    CDN mask (the `use_dn`-alone model embeds their position with
    `pos_trans`), and `num_dn` is returned,
  - look-forward-twice: each layer's keypoint outputs stand on the
    undetached reference the layer before made.

In train mode (`module.train()`) dropout is on, as in the JAX package's
`Drop` and its decoder self-attention's weight dropout, drawing from the
`torch.Generator` passed to `forward` (never the global RNG); the decoder's
reference points and the two-stage proposals are detached where the JAX
transformer stops the gradient. Parameter names follow the reference state
dict (`transformer.encoder.layers.{i}.*`, `transformer.pos_trans.{0,2,4}`...).
The class and keypoint heads belong to `UVHandDETR` (reference names
`cls_embed.{i}`, `key_embed.{i}`...) and are passed into `forward`, since the
decoder's refinement is gated on them.

With `remat` (train mode only) each encoder and decoder layer runs under
`torch.utils.checkpoint`: its activations are dropped after the forward and
recomputed in the backward, as the JAX package's `nn.remat` does. The
recompute replays the layer's dropout draws from the generator state at the
layer's entry, so it draws the masks the forward drew.

`compute_dtype` places bf16 exactly where the JAX transformer's
`compute_dtype` does, layer by layer (not by autocast, whose op lists put it
elsewhere): the MSDA value path, the FFN's two linears (the second cast back
to float32), the decoder self-attention (projections, scores, softmax and
weight dropout) and `pos_trans` with the proposal embedding feeding it.
LayerNorms, `enc_output`, the heads and the residual stream compute in
the promoted type of their input and parameters (`layers.py`): float32 with
float32 parameters. With bfloat16 parameters (`--bf16_params`) that type is
bfloat16 wherever the input is too, as in the JAX model: the first encoder
layer's residual input, `pos_trans_norm` and so the decoder queries, the
first decoder layer's residual stream and its offset/attention GEMM.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.msda import MSDeformAttn, dense
from .layers import LayerNorm, Linear
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
        self.layers = nn.ModuleList(Linear(i, o) for i, o in zip(dims, outs))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def keep_mask(shape, keep: float, generator: torch.Generator | None, device):
    """Bernoulli(keep) mask drawn from `generator`; train-mode randomness
    never falls back to the global RNG."""
    if generator is None:
        raise ValueError("train-mode randomness draws from an explicit torch.Generator; "
                         "pass generator=")
    return torch.rand(shape, generator=generator, device=device) < keep


def rounded(x: float, dtype: torch.dtype) -> float:
    """The constant `x` as `dtype` holds it (on the host: no device copy).
    JAX turns a Python constant into the array's type before it computes,
    so a bf16 activation is scaled by bf16(x); torch would take x itself."""
    return torch.tensor(x, dtype=dtype).item()


class Drop(nn.Module):
    """Inverted dropout in train mode (keep each element with probability
    1 - rate, scale the kept ones by 1 / (1 - rate), that constant in the
    activation's type); the identity in eval mode. Port of the JAX
    package's `Drop`."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: torch.Generator | None):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        return torch.where(keep_mask(x.shape, keep, generator, x.device),
                           x / rounded(keep, x.dtype), 0.0)


def self_attention(mha: nn.MultiheadAttention, q, v, rate: float,
                   generator: torch.Generator | None, dtype: torch.dtype = torch.float32,
                   attn_mask: torch.Tensor | None = None):
    """Multi-head attention from `mha`'s own `in_proj_*` / `out_proj`, as
    flax's `MultiHeadDotProductAttention(dtype=dtype)` computes it: every
    projection, the scores, the softmax and the output in `dtype` (flax
    upcasts nowhere), queries divided by sqrt(head_dim) in `dtype` before
    the product, and in train mode dropout on the softmaxed weights with
    ONE (Lq, Lk) keep mask broadcast over batch and heads (flax's
    `broadcast_dropout=True`), its 1 / keep also in `dtype`. `attn_mask`
    (Lq, Lk) bool, True = blocked (the CDN mask), sets those scores to the
    least finite value of `dtype` before the softmax, as flax does."""
    B, N, E = q.shape
    h = mha.num_heads
    w_q, w_k, w_v = mha.in_proj_weight.to(dtype).chunk(3)
    b_q, b_k, b_v = mha.in_proj_bias.to(dtype).chunk(3)
    q, v = q.to(dtype), v.to(dtype)

    def heads(x, w, b):
        return F.linear(x, w, b).view(B, -1, h, E // h).transpose(1, 2)  # (B, h, n, hd)

    qh = heads(q, w_q, b_q) / rounded(math.sqrt(E // h), dtype)
    scores = qh @ heads(q, w_k, b_k).transpose(-1, -2)
    if attn_mask is not None:
        scores = scores.masked_fill(attn_mask, torch.finfo(dtype).min)
    weights = torch.softmax(scores, -1)
    if mha.training and rate > 0.0:
        keep = 1.0 - rate
        mask = keep_mask(weights.shape[-2:], keep, generator, q.device)
        weights = weights * (mask.to(dtype) / rounded(keep, dtype))
    out = (weights @ heads(v, w_v, b_v)).transpose(1, 2).reshape(B, N, E)
    return dense(mha.out_proj, out, dtype)


def feed_forward(layer: nn.Module, x: torch.Tensor, generator: torch.Generator | None):
    """The FFN of an encoder or decoder layer: `linear1`, ReLU and dropout in
    the layer's compute type, `linear2`'s output cast to float32."""
    dt = layer.compute_dtype
    ff = layer.drop(torch.relu(dense(layer.linear1, x, dt)), generator)
    return dense(layer.linear2, ff, dt).float()


class EncoderLayer(nn.Module):
    def __init__(self, d_model=256, d_ffn=1024, n_levels=4, n_heads=8, n_points=4,
                 dropout=0.1, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                      compute_dtype=compute_dtype)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.drop = Drop(dropout)

    def forward(self, src, pos, reference_points, spatial_shapes, padding_mask, generator=None,
                value=None):
        """`value`: the whole token sequence to sample from where `src` is
        only some of the queries (enc_lite's low-resolution-only layers);
        None samples `src` itself."""
        src2 = self.self_attn(src + pos, reference_points, src if value is None else value,
                              spatial_shapes, padding_mask)
        src = self.norm1(src + self.drop(src2, generator))
        return self.norm2(src + self.drop(feed_forward(self, src, generator), generator))


class DecoderLayer(nn.Module):
    def __init__(self, d_model=256, d_ffn=1024, n_levels=4, n_heads=8, n_points=4,
                 dropout=0.1, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                       compute_dtype=compute_dtype)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        # a container of the reference's parameter names; `self_attention`
        # computes it
        self.self_attn = nn.MultiheadAttention(d_model, n_heads, batch_first=True)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = LayerNorm(d_model, eps=1e-5)
        self.drop = Drop(dropout)

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes, src_padding_mask,
                generator=None, self_attn_mask=None):
        """`self_attn_mask` (Lq, Lq) bool, True = blocked: the CDN mask."""
        q = tgt + query_pos
        tgt2 = self_attention(self.self_attn, q, tgt, self.drop.rate, generator,
                              self.compute_dtype, self_attn_mask)
        tgt = self.norm2(tgt + self.drop(tgt2, generator))
        tgt2 = self.cross_attn(tgt + query_pos, reference_points, src, spatial_shapes,
                               src_padding_mask)
        tgt = self.norm1(tgt + self.drop(tgt2, generator))
        return self.norm3(tgt + self.drop(feed_forward(self, tgt, generator), generator))


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


def proposal_pos_embed(proposals: torch.Tensor, num_pos_feats: int = 128,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """42-d unactivated proposal -> (B, Q, 42*num_pos_feats) sine embedding,
    computed in float32 and cast to `dtype`."""
    scale = 2 * math.pi
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=proposals.device)
    dim_t = 10000.0 ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    p = torch.sigmoid(proposals) * scale
    pos = interleaved_sincos(p[..., None] / dim_t)  # (B, Q, 42, F)
    return pos.to(dtype).flatten(2)


def sine_embed_42(pos: torch.Tensor) -> torch.Tensor:
    """The DINO variant's per-layer query position embedding of 42-d
    reference points: the mean of the 21 x and of the 21 y coordinates, each
    as a 128-d sine embedding, (B, Q, 256) ordered [y, x]."""
    dim_t = torch.arange(128, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2 * torch.floor(dim_t / 2) / 128)
    scale = 2 * math.pi
    x = pos[..., 0::2].mean(-1) * scale
    y = pos[..., 1::2].mean(-1) * scale
    return torch.cat([interleaved_sincos(y[..., None] / dim_t),
                      interleaved_sincos(x[..., None] / dim_t)], -1)


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


def remat(fn, generator: torch.Generator | None):
    """`fn(generator)` under `torch.utils.checkpoint` (non-reentrant): its
    activations are recomputed in the backward. `checkpoint` restores only
    the global RNGs, so the recompute is run from the generator's state at
    the call -- drawing the masks the forward drew -- and the generator is
    put back where the backward found it."""
    if generator is None:
        return checkpoint(fn, None, use_reentrant=False, preserve_rng_state=False)
    start = generator.get_state()
    ran = []

    def run(gen):
        if not ran:  # the forward
            ran.append(True)
            return fn(gen)
        end = gen.get_state()  # the recompute, during the backward
        gen.set_state(start)
        try:
            return fn(gen)
        finally:
            gen.set_state(end)

    return checkpoint(run, generator, use_reentrant=False, preserve_rng_state=False)


class DeformableTransformer(nn.Module):
    def __init__(self, d_model=256, n_heads=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=1024, num_feature_levels=4,
                 dec_n_points=4, enc_n_points=4, num_queries=300, dropout=0.1,
                 two_stage=True, with_box_refine=True, enc_lite=False, enc_lite_hi_every=3,
                 remat=False, compute_dtype=torch.float32, dino_variant=False,
                 look_forward_twice=False, num_classes=14):
        super().__init__()
        if dino_variant and not two_stage:
            # the JAX model builds the per-layer query-position MLP with the
            # two-stage parts only, and then calls it in every decoder layer
            raise ValueError("dino_variant=True with two_stage=False: the JAX model fails to "
                             "build this combination (no ref_point_head)")
        if two_stage and not (with_box_refine or dino_variant):
            # the JAX model builds no keypoint heads there and then indexes
            # them for the encoder's proposals
            raise ValueError("two_stage=True with with_box_refine=False: the JAX model fails "
                             "to build this combination (no keypoint heads for the two-stage "
                             "proposals)")
        self.d_model = d_model
        self.compute_dtype = compute_dtype
        self.num_queries = num_queries
        self.num_decoder_layers = num_decoder_layers
        self.two_stage = two_stage
        self.dino = dino_variant
        self.refine = two_stage and (with_box_refine or dino_variant)
        self.look_forward_twice = look_forward_twice
        self.enc_lite = enc_lite
        self.enc_lite_hi_every = enc_lite_hi_every
        self.remat = remat
        self.encoder = _Layers(
            EncoderLayer(d_model, dim_feedforward, num_feature_levels, n_heads, enc_n_points,
                         dropout, compute_dtype)
            for _ in range(num_encoder_layers))
        self.decoder = _Layers(
            DecoderLayer(d_model, dim_feedforward, num_feature_levels, n_heads, dec_n_points,
                         dropout, compute_dtype)
            for _ in range(num_decoder_layers))
        self.level_embed = nn.Parameter(torch.zeros(num_feature_levels, d_model))
        if two_stage:
            self.enc_output = Linear(d_model, d_model)
            self.enc_output_norm = LayerNorm(d_model, eps=1e-5)
        if dino_variant:
            # learned content queries, the per-layer query-position MLP of
            # the 256-d sine embedding, the norm of every decoder output, and
            # the encoder output's own heads (the decoder's are tied, on
            # UVHandDETR); the xy spread under DINO's name
            self.tgt_embed = nn.Embedding(num_queries, d_model)
            self.decoder.ref_point_head = MLP(256, d_model, d_model, 2)
            self.decoder.norm = LayerNorm(d_model, eps=1e-5)
            self.enc_out_class_embed = Linear(d_model, num_classes)
            self.enc_out_key_embed = MLP(d_model, d_model, 42, 3)
            self.enc_out_obj_key_embed = MLP(d_model, d_model, 42, 3)
            self.two_stage_wh_embedding = nn.Embedding(1, 40)
        elif two_stage:
            self.pos_trans = nn.Sequential(
                nn.Linear(42 * 128, 1024), nn.ReLU(),
                nn.Linear(1024, 1024), nn.ReLU(),
                nn.Linear(1024, 2 * d_model), nn.ReLU())
            self.pos_trans_norm = LayerNorm(2 * d_model, eps=1e-5)
            # Embedding(1, 40), init logit(0.05)
            self.two_stage_learn_xy = nn.Embedding(1, 40)
        else:
            self.reference_points = Linear(d_model, 2)

    @property
    def learn_xy(self) -> nn.Embedding:
        """The two-stage proposals' learned xy spread (DINO's name for it is
        `two_stage_wh_embedding`)."""
        return self.two_stage_wh_embedding if self.dino else self.two_stage_learn_xy

    def _layer(self, layer, generator, *args, **kwargs):
        """`layer(*args, generator=generator, **kwargs)`, rematerialized in
        the backward when `remat` is on and the model trains."""
        fn = functools.partial(layer, *args, **kwargs)
        if self.remat and self.training and torch.is_grad_enabled():
            return remat(lambda gen: fn(generator=gen), generator)
        return fn(generator=generator)

    def _gen_proposals(self, memory, padding_mask, spatial_shapes):
        """(memory', proposals): gen_encoder_output_proposals."""
        B = memory.shape[0]
        dev = memory.device
        learn_xy = torch.sigmoid(self.learn_xy.weight[0])  # (40,)
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

    def _pos_trans(self, pe: torch.Tensor) -> torch.Tensor:
        """The proposal-embedding MLP and its norm: (B, Q, 42*128) -> (B, Q, 2C)."""
        for lin in self.pos_trans[::2]:  # the three linears, each followed by a ReLU
            pe = torch.relu(dense(lin, pe, self.compute_dtype))
        return self.pos_trans_norm(pe)

    def _two_stage_inputs(self, memory, mask_flat, spatial_shapes, cls_embed, key_embed,
                          obj_key_embed):
        """The decoder's queries, query positions (None for the DINO variant,
        whose are per layer) and 42-d references from the encoder's top-k
        proposals, and the interm outputs."""
        nd = self.num_decoder_layers
        out_mem, out_props = self._gen_proposals(memory, mask_flat, spatial_shapes)
        if self.dino:
            enc_cls = self.enc_out_class_embed(out_mem)
            # the proposal added per dimension: the non-root dims get the
            # learned spread
            enc_hand = self.enc_out_key_embed(out_mem) + out_props
            enc_obj = self.enc_out_obj_key_embed(out_mem) + out_props
        else:
            enc_cls = cls_embed[nd](out_mem)
            # root x added to the even dims, root y to the odd dims
            root = out_props[..., 0:2].repeat(1, 1, 21)
            enc_hand = key_embed[nd](out_mem) + root
            enc_obj = obj_key_embed[nd](out_mem) + root

        scores = enc_cls.max(-1).values
        # largest first, the lower index first among equal scores: the order
        # of `jax.lax.top_k` (torch.topk leaves ties in no stated order)
        topk_idx = torch.sort(scores, dim=1, descending=True, stable=True).indices[
            :, :self.num_queries]  # (B, Q)

        def take(x):
            return torch.gather(x, 1, topk_idx[..., None].expand(-1, -1, x.shape[-1]))

        cls_idx = torch.gather(enc_cls.argmax(-1), 1, topk_idx)
        hand_m, obj_m = _class_masks(cls_idx)
        # the decoder's initial references carry no gradient back into the
        # encoder heads (they train through the interm outputs only)
        hand_kp, obj_kp = take(enc_hand).detach(), take(enc_obj).detach()
        ref_unact = take(out_props).detach()
        ref_unact = torch.where(obj_m[..., None], obj_kp, ref_unact)
        ref_unact = torch.where(hand_m[..., None], hand_kp, ref_unact)
        reference_points = torch.sigmoid(ref_unact) * 2 - 1  # [-1, 1] quirk

        if self.dino:
            tgt = self.tgt_embed.weight[None].expand(memory.shape[0], -1, -1)
            # the interm logits from the undetached top-k memory; the interm
            # keys detached and hand/object SWAPPED, as the JAX model (and
            # the reference) does
            enc_outputs = {
                "pred_logits": self.enc_out_class_embed(take(out_mem)),
                "pred_hand_key_unact": obj_kp,
                "pred_obj_key_unact": hand_kp,
            }
            return tgt, None, reference_points, enc_outputs

        pt = self._pos_trans(proposal_pos_embed(ref_unact, dtype=self.compute_dtype))
        query_pos, tgt = torch.split(pt, self.d_model, -1)
        enc_outputs = {
            "pred_logits": enc_cls,
            "pred_hand_key_unact": enc_hand,
            "pred_obj_key_unact": enc_obj,
        }
        return tgt, query_pos, reference_points, enc_outputs

    def forward(
        self,
        srcs: Sequence[torch.Tensor],  # L x (B, C, H_l, W_l)
        masks: Sequence[torch.Tensor],  # L x (B, H_l, W_l) True = pad
        pos_embeds: Sequence[torch.Tensor],  # L x (B, H_l, W_l, C)
        cls_embed: nn.ModuleList,  # a class head per decoder layer (+1 two-stage)
        key_embed: nn.ModuleList | None,  # hand keypoint MLPs (two-stage box refine)
        obj_key_embed: nn.ModuleList | None,  # object keypoint MLPs (likewise)
        generator: torch.Generator | None = None,  # dropout draws (train mode)
        query_embed: torch.Tensor | None = None,  # (Q, 2C) learned queries (single stage)
        dn: tuple | None = None,  # CDN: (content (B, P, C), refs unact (B, P, 42), mask)
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
        n_hi = spatial_shapes[0][0] * spatial_shapes[0][1]  # level-0 tokens
        n_enc = len(self.encoder.layers)
        for i, layer in enumerate(self.encoder.layers):
            if (not self.enc_lite or (i + 1) % self.enc_lite_hi_every == 0
                    or i == n_enc - 1):
                memory = self._layer(layer, generator, memory, pos_flat, enc_ref,
                                     spatial_shapes, mask_flat)
            else:
                # refine the low-resolution tokens only; they sample the whole
                # partially updated sequence under the full padding mask
                lo = self._layer(layer, generator, memory[:, n_hi:], pos_flat[:, n_hi:],
                                 enc_ref[:, n_hi:], spatial_shapes, mask_flat, value=memory)
                memory = torch.cat([memory[:, :n_hi], lo], 1)

        # ---- decoder inputs ----
        enc_outputs = None
        if self.two_stage:
            tgt, query_pos, reference_points, enc_outputs = self._two_stage_inputs(
                memory, mask_flat, spatial_shapes, cls_embed, key_embed, obj_key_embed)
        else:
            query_pos, tgt = torch.split(query_embed, self.d_model, -1)
            query_pos = query_pos[None].expand(B, -1, -1)
            tgt = tgt[None].expand(B, -1, -1)
            reference_points = torch.sigmoid(self.reference_points(query_pos))

        # ---- contrastive-denoising queries, ahead of the matching ones ----
        num_dn, self_attn_mask = 0, None
        if dn is not None:
            dn_tgt, dn_refs_unact, self_attn_mask = dn
            num_dn = dn_tgt.shape[1]
            if query_pos is not None:  # `use_dn` alone: a fixed dn query position
                dn_pos = self._pos_trans(proposal_pos_embed(dn_refs_unact))
                query_pos = torch.cat([dn_pos[..., :self.d_model], query_pos], 1)
            tgt = torch.cat([dn_tgt, tgt], 1)
            reference_points = torch.cat([torch.sigmoid(dn_refs_unact) * 2 - 1,
                                          reference_points], 1)

        # ---- decoder, with gated reference refinement (two-stage) ----
        hs_list, refs_in, logits_list, deltas = [], [], [], []
        # the refs entering each layer with their gradient into the previous
        # layer's refinement (look-forward-twice)
        refs_undet = [reference_points]
        output = tgt
        ref = reference_points
        if ref.shape[-1] == 42:
            vr = valid_ratios.repeat(1, 1, 21)[:, None]  # (B, 1, L, 42)
        else:
            vr = valid_ratios[:, None]  # (B, 1, L, 2)
        for lid, layer in enumerate(self.decoder.layers):
            refs_in.append(ref)
            ref_input = ref[:, :, None] * vr
            if self.dino:
                # the per-layer query position, from the level-0 reference input
                query_pos = self.decoder.ref_point_head(sine_embed_42(ref_input[:, :, 0]))
            output = self._layer(layer, generator, output, query_pos, ref_input,
                                 memory, spatial_shapes, mask_flat,
                                 self_attn_mask=self_attn_mask)
            # the DINO variant norms every output it reports; the refinement
            # reads the raw one
            normed = self.decoder.norm(output) if self.dino else output
            hs_list.append(normed)
            logits = cls_embed[lid](output)
            logits_list.append(cls_embed[lid](normed) if self.dino else logits)
            if not self.refine:
                continue
            hand_m, obj_m = _class_masks(logits.argmax(-1))
            d_hand = key_embed[lid](output)
            d_obj = obj_key_embed[lid](output)
            deltas.append((d_hand, d_obj))
            delta = torch.where(hand_m[..., None], d_hand,
                                torch.where(obj_m[..., None], d_obj, 0.0))
            new_ref = torch.sigmoid(inverse_sigmoid(ref) + delta) * 2 - 1
            refs_undet.append(new_ref)
            ref = new_ref.detach()

        # per-layer keypoint outputs: delta + inverse_sigmoid(the layer's ref
        # input), detached but under look-forward-twice, so the keypoint
        # heads train through these outputs (and, look-forward-twice, each
        # layer's refinement through the next layer's outputs)
        if self.look_forward_twice and self.refine:
            refs_in = refs_undet[:self.num_decoder_layers]
        hand_keys, obj_keys = [], []
        for lid, d in enumerate(deltas):
            if self.dino:  # the heads read the normed output here
                d = (key_embed[lid](hs_list[lid]), obj_key_embed[lid](hs_list[lid]))
            base = inverse_sigmoid(refs_in[lid])
            hand_keys.append(torch.sigmoid(d[0] + base) * 2 - 1)
            obj_keys.append(torch.sigmoid(d[1] + base) * 2 - 1)

        return {
            "hs": torch.stack(hs_list),  # (n_dec, B, P + Q, C)
            "init_reference": reference_points,
            "refs_in": torch.stack(refs_in),
            "pred_logits": torch.stack(logits_list),
            "pred_hand_key": torch.stack(hand_keys) if self.refine else None,
            "pred_obj_key": torch.stack(obj_keys) if self.refine else None,
            "enc_outputs": enc_outputs,
            "memory": memory,
            "num_dn": num_dn,
        }
