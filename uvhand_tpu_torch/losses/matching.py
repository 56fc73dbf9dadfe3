"""Hungarian matching on the device, for at most a few targets per image.

Port of `uvhand_tpu/losses/matching.py`. ARCTIC images have at most T = 3
targets (object, left hand, right hand), so the assignment is solved exactly
without a host round trip: in an optimal assignment each target's query is
among the T cheapest queries of its column, so the T masked argmins of every
column and the T^T combinations of those candidates hold the optimum.
Batched over images as a leading dimension (the JAX package vmaps); ties go
to the first index, as `torch.argmin` and `jnp.argmin` both return it.

Cost (the reference's `ArcticMatcher`): focal-style class cost plus an L1
keypoint cost routed to the hand head for labels {12, 13} and to the object
head otherwise.
"""

from __future__ import annotations

import itertools

import torch

BIG = 1e9


def hungarian_small(cost: torch.Tensor, target_valid: torch.Tensor) -> torch.Tensor:
    """Exact min-cost assignment per image.

    cost (B, Q, T); target_valid (B, T) bool. Returns (B, T) int64: the query
    assigned to each target, -1 for an invalid target."""
    B, Q, T = cost.shape
    # invalid targets cost 0 everywhere: they absorb a spare query without
    # moving the optimum of the valid ones
    costT = torch.where(target_valid[:, None, :], cost, 0.0).transpose(1, 2)  # (B, T, Q)
    work = costT
    K = min(T, Q)
    cand_q, cand_c = [], []
    for _ in range(K):
        qi = work.argmin(2)  # (B, T)
        cand_q.append(qi)
        cand_c.append(torch.gather(costT, 2, qi[..., None])[..., 0])
        work = work.scatter(2, qi[..., None], BIG)
    cand_q = torch.stack(cand_q, 2)  # (B, T, K)
    cand_c = torch.stack(cand_c, 2)

    # (K^T, T): which candidate each target picks, first target slowest
    combos = torch.tensor(list(itertools.product(range(K), repeat=T)), device=cost.device)
    t_idx = torch.arange(T, device=cost.device)[None, :]
    qs = cand_q[:, t_idx, combos]  # (B, C, T) chosen query per target
    cc = torch.where(target_valid[:, None, :], cand_c[:, t_idx, combos], 0.0)
    total = cc[..., 0]
    for t in range(1, T):
        total = total + cc[..., t]
    clash = torch.zeros_like(total, dtype=torch.bool)
    for i in range(T):
        for j in range(i + 1, T):
            clash |= ((qs[..., i] == qs[..., j])
                      & target_valid[:, i:i + 1] & target_valid[:, j:j + 1])
    total = torch.where(clash, BIG, total)
    best = total.argmin(1)  # (B,)
    assign = qs[torch.arange(B, device=cost.device), best]
    return torch.where(target_valid, assign, -1)


def arctic_match_costs(
    pred_logits: torch.Tensor,  # (B, Q, C)
    pred_hand_key: torch.Tensor | None,  # (B, Q, 42); None: class cost only
    pred_obj_key: torch.Tensor | None,  # (B, Q, 42)
    tgt_labels: torch.Tensor,  # (B, T) int
    tgt_keypoints: torch.Tensor | None,  # (B, T, 42)
    cost_class: float = 1.5,
    cost_keypoint: float = 4.0,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Per-image (Q, T) matching cost -> (B, Q, T)."""
    prob = torch.sigmoid(pred_logits)
    neg = (1 - alpha) * (prob ** gamma) * (-torch.log(1 - prob + 1e-8))
    pos = alpha * ((1 - prob) ** gamma) * (-torch.log(prob + 1e-8))
    lab = tgt_labels.clamp(min=0).long()
    B, Q = pred_logits.shape[:2]
    cls_cost = torch.gather(pos - neg, 2, lab[:, None, :].expand(B, Q, -1))  # (B, Q, T)

    cost = cost_class * cls_cost
    if tgt_keypoints is None or pred_hand_key is None:  # the single-stage model
        return cost
    is_hand = (tgt_labels == 12) | (tgt_labels == 13)  # (B, T)
    d_hand = (pred_hand_key[:, :, None, :] - tgt_keypoints[:, None, :, :]).abs().sum(-1)
    d_obj = (pred_obj_key[:, :, None, :] - tgt_keypoints[:, None, :, :]).abs().sum(-1)
    kp_cost = torch.where(is_hand[:, None, :], d_hand, d_obj)
    return cost + cost_keypoint * kp_cost


@torch.no_grad()
def arctic_match(pred_logits, pred_hand_key, pred_obj_key, tgt_labels, tgt_keypoints,
                 target_valid, cost_class: float = 1.5, cost_keypoint: float = 4.0):
    """Batched matching -> assign (B, T): query per target or -1."""
    cost = arctic_match_costs(pred_logits, pred_hand_key, pred_obj_key, tgt_labels,
                              tgt_keypoints, cost_class, cost_keypoint)
    return hungarian_small(cost, target_valid)
