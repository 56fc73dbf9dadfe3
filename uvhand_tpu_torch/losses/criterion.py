"""Query selection for serving.

Port of `select_queries` from `uvhand_tpu/losses/criterion.py` (the
reference's `get_arctic_item`). The training criterion is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch


NUM_OBJ_CLASSES = 11  # object classes 1..11; 12 / 13 are the left / right hand


def select_queries(stacked_layer: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per image: the best object query (highest probability over classes
    1..11) and the argmax queries of the left (12) and right (13) hand
    classes; returns their parameters. Ties go to the lowest index, as in
    JAX's argmax."""
    prob = torch.sigmoid(stacked_layer["pred_logits"])

    obj_probs = prob[:, :, 1: 1 + NUM_OBJ_CLASSES]  # (B, Q, 11)
    per_class_score, per_class_best_q = obj_probs.max(1)  # (B, 11)
    best_class = per_class_score.argmax(1)  # (B,)
    obj_q = torch.gather(per_class_best_q, 1, best_class[:, None])[:, 0]
    left_q = prob[:, :, 12].argmax(1)
    right_q = prob[:, :, 13].argmax(1)

    def g(x, q):
        return x[torch.arange(x.shape[0], device=x.device), q]

    return {
        "root.l": g(stacked_layer["pred_hand_cam"], left_q),
        "root.r": g(stacked_layer["pred_hand_cam"], right_q),
        "root.o": g(stacked_layer["pred_obj_cam"], obj_q),
        "pose.l": g(stacked_layer["pred_mano_pose"], left_q),
        "pose.r": g(stacked_layer["pred_mano_pose"], right_q),
        "beta.l": g(stacked_layer["pred_mano_beta"], left_q),
        "beta.r": g(stacked_layer["pred_mano_beta"], right_q),
        "obj_rot": g(stacked_layer["pred_obj_rot"], obj_q),
        "obj_rad": g(stacked_layer["pred_obj_rad"], obj_q)[..., 0],
        "query.l": left_q,
        "query.r": right_q,
        "query.o": obj_q,
    }
