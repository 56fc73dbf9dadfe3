"""ARCTIC DETR criterion and query selection.

Port of `uvhand_tpu/losses/criterion.py` (the reference's
`SetArcticCriterion` and `compute_small_loss` of `loss_arctic_sf.py`):
Hungarian-matched focal class loss and hand/object keypoint L1 for every
decoder layer and for the encoder's interm outputs, and the hand/object
parameter, keypoint and contact losses of the queries each layer selects.
For the single-stage model (its outputs carry no keypoints and no interm
outputs, the JAX package's `two_stage=False`) the matching is by class
alone and there is neither a keypoint loss nor an interm term. Every layer of `stacked` is summed whether or not
the model was built with `aux_loss`, as in the JAX package. The denoising
queries' outputs (`dn_outputs`, the DINO variant and `use_dn`) add the
`*_dn` losses of `models/dn.py::dn_losses`, each weighted as its base name.
A temporal head's refined parameters (`temporal_selected`) add one more
small-loss pass, its keys `<name>/temporal`, each weighted as the last
layer's `<name>`.

The JAX package vmaps the per-layer losses over the decoder layers; here the
layers are folded into the batch, as the JAX package folds them for the
matcher: one query selection, one MANO forward a hand and one object forward
on the L*B rows, and the detection losses on the (L, B, ...) outputs, so the
host dispatches one layer's ops, not L layers'. Every reduction stays within its
layer -- the masked means, the contact deviation's means and the
batch-neighbour smoothing term reduce over everything but the layer axis --
and each term is an (L,) vector; the per-hand gates
sum(is_valid * hand_valid) > 0 read the targets alone. The total is one
weighted sum over the (term, layer) stack. Every data-dependent branch of the
reference is a masked mean; nothing syncs with the host.

Loss keys are the JAX package's: `name` for the last layer, `name_{l}` for
layer l < L-1, `*_dn` / `*_dn_{l}`, `<name>/temporal`, `*_interm`,
`cardinality_error` and `total`.

The matcher's calls are spans `match`, the per-layer and temporal small
losses spans `layer_losses` (`utils.spans`).
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

from ..geometry import camera
from ..geometry.mano import MANOModel, mano_forward
from ..geometry.objects import ObjectBank, object_forward
from ..geometry.rotations import axis_angle_to_matrix
from ..models.dn import dn_losses
from ..utils.spans import span
from .matching import arctic_match

NUM_OBJ_CLASSES = 11  # object classes 1..11; 12 / 13 are the left / right hand
CONTACT_DIST = 3e-3  # 3 mm

DEFAULT_LOSS_WEIGHTS = {
    "loss_ce": 2.0,
    "loss_hand_keypoint": 5.0,
    "loss_obj_keypoint": 5.0,
    "loss/object/v3d_smoothing": 0.0005,
    "loss/mano/cam_t/r": 1.0,
    "loss/mano/cam_t/l": 1.0,
    "loss/object/cam_t": 1.0,
    "loss/mano/kp2d/r": 5.0,
    "loss/mano/kp3d/r": 5.0,
    "loss/mano/pose/r": 10.0,
    "loss/mano/beta/r": 0.001,
    "loss/mano/kp2d/l": 5.0,
    "loss/mano/kp3d/l": 5.0,
    "loss/mano/pose/l": 10.0,
    "loss/mano/beta/l": 0.001,
    "loss/cd": 10.0,
    "loss/mano/transl/l": 10.0,
    "loss/object/kp2d": 1.0,
    "loss/object/kp3d": 5.0,
    "loss/object/radian": 1.0,
    "loss/object/rot": 1.0,
    "loss/object/transl": 10.0,
}


# ---------------------------------------------------------------- utilities


def masked_row_mean(dist: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """dist (L, B, ...), row_valid (B,) -> (L,): each layer's mean over the
    elements of its valid rows; 0 if there is none."""
    n = row_valid.sum()
    per_row = dist.flatten(2)
    s = (per_row * row_valid[:, None]).sum((1, 2))
    denom = n * per_row.shape[2]
    return torch.where(n > 0, s / denom.clamp(min=1.0), 0.0)


def joints_mean(dist: torch.Tensor, jts_valid: torch.Tensor) -> torch.Tensor:
    """dist (L, B, J, ...), jts_valid (B, J) -> (L,): each layer's mean over
    ALL elements of dist * jts_valid."""
    return (dist * jts_valid[..., None]).flatten(1).mean(1)


# --------------------------------------------------------- detection losses


def sigmoid_focal_loss(logits, onehot, num_boxes, alpha=0.25, gamma=2.0):
    """Focal loss, then the reference's * Q scaling; logits (..., B, Q, C)
    -> (...): one loss for each leading index (decoder layer)."""
    p = torch.sigmoid(logits)
    ce = logits.clamp(min=0) - logits * onehot + torch.log1p(torch.exp(-logits.abs()))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    loss = ce * (1 - p_t) ** gamma
    alpha_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    loss = alpha_t * loss
    return loss.mean(-2).sum((-2, -1)) / num_boxes * logits.shape[-2]


def loss_labels(pred_logits, tgt_labels, assign, target_valid, num_boxes):
    """pred_logits (..., B, Q, C); assign (..., B, T): the query per target or
    -1; the targets (B, T). -> (...), a loss for each leading index."""
    C = pred_logits.shape[-1]
    target_classes = torch.full(pred_logits.shape[:-1], C, dtype=torch.long,
                                device=pred_logits.device)
    q_range = torch.arange(pred_logits.shape[-2], device=pred_logits.device)
    for t in range(assign.shape[-1]):
        a = assign[..., t:t + 1]
        hit = (q_range == a) & (a >= 0) & target_valid[:, t:t + 1]
        target_classes = torch.where(hit, tgt_labels[:, t:t + 1].long(), target_classes)
    onehot = F.one_hot(target_classes, C + 1)[..., :-1].to(pred_logits.dtype)
    return sigmoid_focal_loss(pred_logits, onehot, num_boxes)


def loss_keypoints(pred_hand_key, pred_obj_key, tgt_labels, tgt_keypoints, assign, target_valid):
    """L1 on the matched queries, routed to the hand or the object head;
    keys (..., B, Q, 42), assign (..., B, T) -> two (...) losses."""
    q = assign.clamp(min=0)[..., None].expand(*assign.shape, pred_hand_key.shape[-1])
    src_hand = torch.gather(pred_hand_key, -2, q)  # (..., B, T, 42)
    src_obj = torch.gather(pred_obj_key, -2, q)
    valid = target_valid & (assign >= 0)
    hand_label = (tgt_labels == 12) | (tgt_labels == 13)
    is_hand = hand_label & valid
    is_obj = ~hand_label & valid

    def routed(src, mask):
        n = mask.sum((-2, -1))
        l1 = (src - tgt_keypoints).abs().sum(-1)
        return torch.where(n > 0, (l1 * mask).sum((-2, -1)) / n.clamp(min=1) / 21.0, 0.0)

    return routed(src_hand, is_hand), routed(src_obj, is_obj)


# ------------------------------------------------------------ query select


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


# ------------------------------------------------------------- small loss


def compute_small_loss(
    pred: Dict[str, torch.Tensor],
    gt: Dict[str, torch.Tensor],
    mano_r: MANOModel,
    mano_l: MANOModel,
    obj_bank: ObjectBank,
    img_res: float,
) -> Dict[str, torch.Tensor]:
    """The reference's `compute_small_loss` for the selected queries of L
    layers at once, with masked means in place of its branches: a hand's
    terms are gated on sum(is_valid * hand_valid) > 0 over the batch, and
    inside a branch the masks are the plain hand/joint valids, as the JAX
    package keeps them. `pred`'s rows are layer-major, L*B against the B of
    `gt`; each term is an (L,) vector of per-layer losses, a scalar where
    L = 1."""
    K = gt["intrinsics"]
    B = K.shape[0]
    L = pred["root.r"].shape[0] // B

    def layers(x):  # (L*B, ...) -> (L, B, ...)
        return x.reshape(L, B, *x.shape[1:])

    K_layers = K.expand(L, *K.shape)  # each layer's own product, as one layer's call has it
    avg_f = (K[:, 0, 0] + K[:, 1, 1]) / 2.0
    root = {side: layers(pred[f"root.{side}"]) for side in "lro"}
    cam_t = {side: camera.weak_perspective_to_perspective(r, avg_f, img_res)
             for side, r in root.items()}

    is_valid = gt["is_valid"].float()
    right_valid = gt["right_valid"].float()
    left_valid = gt["left_valid"].float()
    gate_r = ((is_valid * right_valid).sum() > 0).float()
    gate_l = ((is_valid * left_valid).sum() > 0).float()

    out: Dict[str, torch.Tensor] = {}

    def hand_losses(side, mano_model, hand_valid, jv, gate):
        pose = pred[f"pose.{side}"]
        beta = pred[f"beta.{side}"]
        verts, joints = mano_forward(mano_model, pose[:, :3], pose[:, 3:], beta)
        j3d_cam = layers(joints) + cam_t[side][..., None, :]
        v3d_cam = layers(verts) + cam_t[side][..., None, :]
        j2d = camera.normalize_kp2d(camera.project2d(K_layers, j3d_cam), img_res)
        gt_pose_m = axis_angle_to_matrix(gt[f"mano.pose.{side}"].reshape(-1, 16, 3))
        pose_m = layers(axis_angle_to_matrix(pose.reshape(-1, 16, 3)))

        out[f"loss/mano/kp2d/{side}"] = gate * joints_mean(
            (j2d - gt[f"mano.j2d.norm.{side}"]) ** 2, jv)
        out[f"loss/mano/pose/{side}"] = gate * masked_row_mean((pose_m - gt_pose_m) ** 2,
                                                               hand_valid)
        out[f"loss/mano/beta/{side}"] = gate * masked_row_mean(
            (layers(beta) - gt[f"mano.beta.{side}"]) ** 2, hand_valid)
        out[f"loss/mano/cam_t/{side}"] = gate * masked_row_mean(
            (root[side] - gt[f"mano.cam_t.wp.{side}"]) ** 2, hand_valid)
        # root-aligned kp3d
        pr = j3d_cam - j3d_cam[..., :1, :]
        gtr = gt[f"mano.j3d.cam.{side}"] - gt[f"mano.j3d.cam.{side}"][:, :1]
        out[f"loss/mano/kp3d/{side}"] = gate * joints_mean((pr - gtr) ** 2, jv)
        return v3d_cam

    v3d_cam_l = hand_losses("l", mano_l, left_valid, gt["joints_valid_l"].float(), gate_l)
    v3d_cam_r = hand_losses("r", mano_r, right_valid, gt["joints_valid_r"].float(), gate_r)

    # object/transl lives inside the reference's right-hand branch
    out["loss/object/transl"] = gate_r * masked_row_mean(
        ((root["o"] - root["r"]) - (gt["object.cam_t.wp"] - gt["mano.cam_t.wp.r"])) ** 2,
        right_valid * is_valid)
    # transl/l needs both branches live; its mask has no is_valid
    out["loss/mano/transl/l"] = gate_l * gate_r * masked_row_mean(
        ((root["l"] - root["r"]) - (gt["mano.cam_t.wp.l"] - gt["mano.cam_t.wp.r"])) ** 2,
        right_valid * left_valid)

    obj_idx = gt["query_idx"].expand(L, B).reshape(L * B)
    obj_out = object_forward(obj_bank, pred["obj_rad"], pred["obj_rot"], obj_idx)
    kp3d_cam_o = layers(obj_out["kp3d"]) + cam_t["o"][..., None, :]
    v3d_cam_o = layers(obj_out["v"]) + cam_t["o"][..., None, :]
    kp2d_o = camera.normalize_kp2d(camera.project2d(K_layers, kp3d_cam_o), img_res)

    out["loss/object/kp2d"] = masked_row_mean((kp2d_o - gt["object.kp2d.norm"]) ** 2, is_valid)
    out["loss/object/cam_t"] = masked_row_mean((root["o"] - gt["object.cam_t.wp"]) ** 2,
                                               is_valid)
    nk = kp3d_cam_o.shape[-2] // 2
    pr = kp3d_cam_o - kp3d_cam_o[..., nk:nk + 1, :]
    gtr = gt["object.kp3d.cam"] - gt["object.kp3d.cam"][:, nk:nk + 1]
    out["loss/object/kp3d"] = masked_row_mean((pr - gtr) ** 2, is_valid)
    out["loss/object/radian"] = masked_row_mean(
        (layers(pred["obj_rad"])[..., None] - gt["object.radian"][:, None]) ** 2, is_valid)
    out["loss/object/rot"] = masked_row_mean((layers(pred["obj_rot"]) - gt["object.rot"]) ** 2,
                                             is_valid)
    # L1 between consecutive batch elements of one layer (the reference's
    # obj_smt_loss)
    out["loss/object/v3d_smoothing"] = (v3d_cam_o[:, 1:] - v3d_cam_o[:, :-1]).abs().sum((1, 2, 3))

    def contact_dev(v_obj, v_hand, dist, idx, hand_valid):
        idx = idx.long()[..., None].expand(L, -1, -1, 3)
        corres = torch.gather(v_obj, 2, idx)  # (L, B, 778, 3)
        disp = torch.linalg.norm(corres - v_hand, dim=-1)  # (L, B, 778)
        contact = (dist <= CONTACT_DIST) & (hand_valid[:, None] > 0)
        n_contact = contact.sum(1)
        per_sample = (disp * contact).sum(2) / n_contact.clamp(min=1)
        has = n_contact > 0
        return (per_sample * has).sum(1) / has.sum().clamp(min=1)

    # the contact deviation multiplies is_valid into the hand mask; each
    # hand's term exists only when its branch is live
    cd_ro = contact_dev(v3d_cam_o, v3d_cam_r, gt["dist.ro"], gt["idx.ro"], right_valid * is_valid)
    cd_lo = contact_dev(v3d_cam_o, v3d_cam_l, gt["dist.lo"], gt["idx.lo"], left_valid * is_valid)
    out["loss/cd"] = gate_r * cd_ro + gate_l * cd_lo
    return out if L > 1 else {k: v[0] for k, v in out.items()}


# ------------------------------------------------------------ full criterion


@functools.lru_cache(maxsize=16)
def _weight_column(weights: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The loss weights as a (terms, 1) column on the device, made once: a
    copy from the host's memory each step would wait on the stream."""
    return torch.tensor(weights, dtype=dtype, device=device)[:, None]


def arctic_criterion(
    outputs: Dict,
    targets: Dict[str, torch.Tensor],
    mano_r: MANOModel,
    mano_l: MANOModel,
    obj_bank: ObjectBank,
    img_res: float = 224.0,
    weights: Dict[str, float] | None = None,
    cost_class: float = 1.5,
    cost_keypoint: float = 4.0,
):
    """-> (total loss, loss dict) over every decoder layer and, where the
    model gives them, the interm outputs. The keypoint terms are taken where
    the outputs hold keypoints (the two-stage model's)."""
    if weights is None:
        weights = DEFAULT_LOSS_WEIGHTS
    st = outputs["stacked"]
    L, B = st["pred_logits"].shape[:2]

    tgt_labels = targets["labels"]
    tgt_kps = targets["keypoints"]
    tgt_valid = targets["target_valid"].bool() & (targets["is_valid"][:, None] > 0)
    # num_boxes counts every target slot, frame-valid or not (the reference
    # counts len(labels) over the batch); only matching is validity-gated
    num_boxes = targets["target_valid"].sum().float().clamp(min=1.0)

    def tile(x):
        return x[None].expand((L,) + x.shape).reshape((L * B,) + x.shape[1:])

    def fold(x):
        return x.reshape(L * B, *x.shape[2:])

    # the single-stage model has no keypoint outputs: matched by class alone
    two_stage = st["pred_hand_key"] is not None
    keys = (fold(st["pred_hand_key"]), fold(st["pred_obj_key"])) if two_stage else (None, None)
    with span("match"):
        assign_all = arctic_match(
            fold(st["pred_logits"]), *keys,
            tile(tgt_labels), tile(tgt_kps), tile(tgt_valid),
            cost_class=cost_class, cost_keypoint=cost_keypoint).reshape(L, B, -1)
    det_names = ("loss_ce", "loss_hand_keypoint", "loss_obj_keypoint")[:3 if two_stage else 1]

    def det_losses(logits, hand_key, obj_key, assign):
        l_ce = loss_labels(logits, tgt_labels, assign, tgt_valid, num_boxes)
        if not two_stage:
            return (l_ce,)
        l_h, l_o = loss_keypoints(hand_key, obj_key, tgt_labels, tgt_kps, assign, tgt_valid)
        return l_ce, l_h, l_o

    loss_dict: Dict[str, torch.Tensor] = {}

    with span("layer_losses"):
        # every layer at once: the detection losses on the (L, B, ...)
        # outputs, the small losses on the selected queries of the L*B rows
        det = det_losses(st["pred_logits"], st["pred_hand_key"], st["pred_obj_key"], assign_all)
        folded = {k: None if v is None else fold(v) for k, v in st.items()}
        small = compute_small_loss(select_queries(folded), targets, mano_r, mano_l, obj_bank,
                                   img_res)
        # the JAX package's pytree (sorted) order of the small losses
        names = list(det_names) + sorted(small)
        terms = torch.stack([v.reshape(L) for v in (*det, *(small[k] for k in names[len(det):]))])
        total = (terms * _weight_column(tuple(weights.get(n, 0.0) for n in names),
                                        terms.device, terms.dtype)).sum()
        for lvl, per_term in enumerate(terms.unbind(1)):
            for name, val in zip(names, per_term.unbind()):
                loss_dict[name if lvl == L - 1 else f"{name}_{lvl}"] = val

    def add(key, name, val):
        nonlocal total
        loss_dict[key] = val
        total = total + weights.get(name, 0.0) * val

    if "dn_outputs" in outputs:
        dn = outputs["dn_outputs"]
        for key, val in dn_losses(dn["pred_logits"], dn["pred_hand_key"], dn["pred_obj_key"],
                                  dn["dn_meta"], num_boxes).items():
            add(key, key.split("_dn")[0], val)

    if outputs.get("temporal_selected") is not None:
        # the temporal head's refined last-layer parameters: one more small
        # loss pass, each term weighted like the last layer's
        with span("layer_losses"):
            small_t = compute_small_loss(outputs["temporal_selected"], targets, mano_r, mano_l,
                                         obj_bank, img_res)
        for name, val in small_t.items():
            add(f"{name}/temporal", name, val)

    if "interm_outputs" in outputs:
        io = outputs["interm_outputs"]
        with span("match"):
            assign_i = arctic_match(io["pred_logits"], io["pred_hand_key"], io["pred_obj_key"],
                                    tgt_labels, tgt_kps, tgt_valid,
                                    cost_class=cost_class, cost_keypoint=cost_keypoint)
        det_i = det_losses(io["pred_logits"], io["pred_hand_key"], io["pred_obj_key"],
                           assign_i)
        for name, val in zip(det_names, det_i):
            add(f"{name}_interm", name, val)

    # cardinality error (logging only): predictions with argmax != 0 against
    # every target slot, validity-unfiltered as in the reference
    with torch.no_grad():
        card_pred = (st["pred_logits"][-1].argmax(-1) != 0).sum(1)
        tgt_len = targets["target_valid"].sum(1)
        loss_dict["cardinality_error"] = (card_pred.float() - tgt_len.float()).abs().mean()

    loss_dict["total"] = total
    return total, loss_dict
