"""Contrastive denoising (CDN) queries of the DINO variant.

Port of `uvhand_tpu/models/dn.py` (the reference's `prepare_for_cdn` and the
dn bookkeeping of its `SetCriterion`, on UVHand's 42-d keypoint targets):
each group holds a positive and a negative copy of the 3 target slots
(object, left, right); labels flip to a random class with probability
label_noise_ratio / 2, keypoints get sign * U(0, 1) * |key| * scale of
noise, one more unit of it for the negatives. The target count is the
static 3 slots, so the group count and the pad width are fixed by
`dn_number`. Invalid target slots ride along: they count as background in
the dn focal CE and are left out of the dn keypoint L1.

`prepare_cdn` draws from an explicit `torch.Generator`; `cdn_draws` (the
four draws) and `noise_cdn` (the arithmetic) are apart, so the JAX
package's draws can be injected.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from .transformer import inverse_sigmoid

T_SLOTS = 3


class CdnConfig(NamedTuple):
    dn_number: int = 100
    label_noise_ratio: float = 0.5
    box_noise_scale: float = 1.0

    @property
    def groups(self) -> int:
        """The reference's sizing: dn_number doubles, then (when >= 100)
        divides by 2 x the target count, here the 3 static slots."""
        n = self.dn_number * 2
        if n >= 100:
            n = n // (T_SLOTS * 2)
        return max(1, n)

    @property
    def pad_size(self) -> int:
        return 2 * self.groups * T_SLOTS


def cdn_draws(generator: torch.Generator, batch: int, num_classes: int, cfg: CdnConfig,
              device=None) -> Dict[str, torch.Tensor]:
    """The four draws of one CDN batch, shaped (B, G, 2, T[, 42]) as the JAX
    package's `jax.random.split(rng, 4)` draws are: the label-flip uniforms,
    the random labels, the noise signs (0 or 1) and the noise magnitudes."""
    lab = (batch, cfg.groups, 2, T_SLOTS)
    key = lab + (42,)
    kw = dict(generator=generator, device=device)
    return {
        "flip": torch.rand(lab, **kw),
        "labels": torch.randint(0, num_classes, lab, **kw),
        "sign": torch.randint(0, 2, key, **kw),
        "part": torch.rand(key, **kw),
    }


def noised_keys(keypoints: torch.Tensor, cfg: CdnConfig,
                draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The noised keypoints (B, P, 42) in [0, 1] of keypoints (B, T, 42)
    under `draws`, before the logit."""
    B, T = keypoints.shape[:2]
    known = keypoints[:, None, None].expand(B, cfg.groups, 2, T, 42)
    sign = draws["sign"].float() * 2 - 1
    is_neg = torch.zeros(1, 1, 2, 1, 1, device=keypoints.device)
    is_neg[:, :, 1] = 1.0
    part = draws["part"] + is_neg
    return (known + sign * part * known * cfg.box_noise_scale).clamp(0.0, 1.0).reshape(
        B, cfg.pad_size, 42)


def noise_cdn(labels: torch.Tensor, keypoints: torch.Tensor, target_valid: torch.Tensor,
              cfg: CdnConfig, draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The dn queries of targets labels (B, T) (-1 pads), keypoints
    (B, T, 42) in ~[0, 1] and target_valid (B, T) under `draws`: the
    layout is G groups of (T positives, T negatives) along the pad."""
    B, T = labels.shape
    G, P = cfg.groups, cfg.pad_size
    known_labels = labels.clamp(min=0)[:, None, None, :].expand(B, G, 2, T)
    valid = target_valid[:, None, None, :].expand(B, G, 2, T)
    flip = draws["flip"] < cfg.label_noise_ratio * 0.5
    noised_labels = torch.where(flip, draws["labels"].to(known_labels.dtype), known_labels)
    negative = torch.zeros(1, G, 2, T, dtype=torch.bool, device=labels.device)
    negative[:, :, 1] = True
    return {
        "dn_labels_noised": noised_labels.reshape(B, P),
        "dn_keys_unact": inverse_sigmoid(noised_keys(keypoints, cfg, draws)),
        "dn_labels_gt": known_labels.reshape(B, P),
        "dn_keys_gt": keypoints[:, None, None].expand(B, G, 2, T, 42).reshape(B, P, 42),
        "dn_valid": valid.reshape(B, P),
        "dn_is_negative": negative.expand(B, G, 2, T).reshape(B, P),
    }


def prepare_cdn(generator: torch.Generator, labels: torch.Tensor, keypoints: torch.Tensor,
                target_valid: torch.Tensor, num_classes: int,
                cfg: CdnConfig) -> Dict[str, torch.Tensor]:
    """`noise_cdn` under fresh draws from `generator`."""
    return noise_cdn(labels, keypoints, target_valid, cfg,
                     cdn_draws(generator, labels.shape[0], num_classes, cfg, labels.device))


def cdn_attn_mask(num_queries: int, cfg: CdnConfig, device=None) -> torch.Tensor:
    """(P + Q, P + Q) bool, True = blocked: the matching queries do not see
    the dn queries, and no dn group sees another."""
    P, per = cfg.pad_size, 2 * T_SLOTS
    group = torch.arange(P + num_queries, device=device) // per
    dn = torch.arange(P + num_queries, device=device) < P
    # a dn query sees its own group and the matching queries; a matching
    # query sees the matching queries
    sees = (group[:, None] == group[None, :]) | ~dn[None, :]
    return ~(sees & (dn[:, None] | ~dn[None, :]))


def dn_losses(dn_logits: torch.Tensor, dn_hand_key: torch.Tensor, dn_obj_key: torch.Tensor,
              dn: Dict[str, torch.Tensor], num_boxes: torch.Tensor,
              focal_alpha: float = 0.25) -> Dict[str, torch.Tensor]:
    """Per-layer dn losses of logits (L, B, P, C) and keypoints (L, B, P, 42),
    keyed `loss_{ce,hand_keypoint,obj_keypoint}_dn` for the last layer and
    `..._dn_{l}` for layer l. Positives classify as their label and regress
    to their keys; negatives and invalid slots classify as background. The
    reference's normalisation: the focal CE over the whole pad divided by
    num_boxes * groups and multiplied by the pad width; the hand and object
    L1 each over its own count of positives, / 21."""
    L, B, P, C = dn_logits.shape
    groups = P // (2 * T_SLOTS)
    valid, neg = dn["dn_valid"], dn["dn_is_negative"]
    pos = valid & ~neg
    target_classes = torch.where(pos, dn["dn_labels_gt"], C)
    onehot = torch.nn.functional.one_hot(target_classes.long(), C + 1)[..., :-1]
    onehot = onehot.to(dn_logits.dtype)
    is_hand = (dn["dn_labels_gt"] == 12) | (dn["dn_labels_gt"] == 13)
    pos_hand, pos_obj = pos & is_hand, pos & ~is_hand

    p = torch.sigmoid(dn_logits)
    ce = (dn_logits.clamp(min=0) - dn_logits * onehot
          + torch.log1p(torch.exp(-dn_logits.abs())))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    a_t = focal_alpha * onehot + (1 - focal_alpha) * (1 - onehot)
    loss = a_t * (ce * (1 - p_t) ** 2)
    l_ce = loss.mean(2).sum((1, 2)) / (num_boxes * groups) * P  # (L,)

    def l1(key, mask):
        err = (key - dn["dn_keys_gt"]).abs().sum(-1) * mask
        return err.sum((1, 2)) / mask.sum().clamp(min=1) / 21.0

    l_hand, l_obj = l1(dn_hand_key, pos_hand), l1(dn_obj_key, pos_obj)
    out = {}
    for lvl in range(L):
        sfx = "_dn" if lvl == L - 1 else f"_dn_{lvl}"
        out[f"loss_ce{sfx}"] = l_ce[lvl]
        out[f"loss_hand_keypoint{sfx}"] = l_hand[lvl]
        out[f"loss_obj_keypoint{sfx}"] = l_obj[lvl]
    return out
