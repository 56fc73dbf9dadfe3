"""COCO-style box AP and the 2.5D keypoint metrics, in numpy.

Port of `uvhand_tpu/evaluation/coco_eval.py`, which stands in for the
reference's pycocotools `CocoEvaluator` (`datasets/coco_eval.py`, the
engine's `eval_coco`): AP@[.5:.95] with 101-point interpolation, greedy IoU
matching, all areas and at most 100 detections, and the pixel MPJPE (uv) and
depth MAE of the AssemblyHands / H2O / FPHA model.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a (N, 4), b (M, 4) xyxy -> (N, M) IoU."""
    area_a = (a[:, 2] - a[:, 0]).clip(0) * (a[:, 3] - a[:, 1]).clip(0)
    area_b = (b[:, 2] - b[:, 0]).clip(0) * (b[:, 3] - b[:, 1]).clip(0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clip(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None] - inter
    return np.where(union > 0, inter / union, 0.0)


def average_precision(scores, matched, n_gt) -> float:
    """101-point interpolated AP from per-detection (score, is_tp)."""
    if n_gt == 0:
        return float("nan")
    order = np.argsort(-np.asarray(scores))
    tp = np.asarray(matched, np.float64)[order]
    fp = 1.0 - tp
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-9)
    # precision envelope
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    out = 0.0
    for r in np.linspace(0, 1, 101):
        p = precision[recall >= r]
        out += (p[0] if len(p) else 0.0) / 101
    return float(out)


def evaluate_detections(
    preds: List[Dict], gts: List[Dict], iou_thresholds=None, max_dets: int = 100
) -> Dict[str, float]:
    """preds/gts: per image {'boxes' (N,4) xyxy, 'scores', 'labels'}.
    Returns {'AP', 'AP50', 'AP75'} averaged over classes present in GT."""
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 1.0, 0.05)
    classes = sorted({int(c) for g in gts for c in np.asarray(g["labels"]).tolist()})
    ap_per_thr = {t: [] for t in iou_thresholds}
    for cls in classes:
        for t in iou_thresholds:
            scores, matched = [], []
            n_gt = 0
            for p, g in zip(preds, gts):
                gm = np.asarray(g["labels"]) == cls
                gb = np.asarray(g["boxes"], np.float64).reshape(-1, 4)[gm]
                n_gt += len(gb)
                pm = np.asarray(p["labels"]) == cls
                pb = np.asarray(p["boxes"], np.float64).reshape(-1, 4)[pm]
                ps = np.asarray(p["scores"], np.float64)[pm]
                order = np.argsort(-ps)[:max_dets]
                pb, ps = pb[order], ps[order]
                used = np.zeros(len(gb), bool)
                iou = box_iou(pb, gb) if len(pb) and len(gb) else np.zeros((len(pb), 0))
                for i in range(len(pb)):
                    j = int(np.argmax(iou[i])) if iou.shape[1] else -1
                    ok = j >= 0 and iou[i, j] >= t and not used[j]
                    if ok:
                        used[j] = True
                    scores.append(ps[i])
                    matched.append(1.0 if ok else 0.0)
            ap = average_precision(scores, matched, n_gt)
            if not np.isnan(ap):
                ap_per_thr[t].append(ap)
    mean = lambda xs: float(np.mean(xs)) if xs else float("nan")
    all_ap = [a for t in iou_thresholds for a in ap_per_thr[t]]
    return {
        "AP": mean(all_ap),
        "AP50": mean(ap_per_thr[iou_thresholds[0]]),
        "AP75": mean(ap_per_thr[iou_thresholds[5]]) if len(iou_thresholds) > 5 else float("nan"),
    }


def assembly_keypoint_metrics(pred_uvd, gt_uvd, valid, img_size=(640, 480)):
    """2.5D keypoint errors for the Assembly/H2O variant.

    pred/gt (B, T, 63) normalized uvd; returns pixel MPJPE (uv) and depth MAE.
    """
    W, H = img_size
    p = np.asarray(pred_uvd).reshape(*np.asarray(pred_uvd).shape[:-1], 21, 3)
    g = np.asarray(gt_uvd).reshape(*np.asarray(gt_uvd).shape[:-1], 21, 3)
    scale = np.array([W, H], np.float64)
    duv = np.linalg.norm((p[..., :2] - g[..., :2]) * scale, axis=-1)  # px
    dz = np.abs(p[..., 2] - g[..., 2])
    v = np.asarray(valid, bool)
    return {
        "mpjpe_uv_px": float(duv[v].mean()) if v.any() else float("nan"),
        "depth_mae": float(dz[v].mean()) if v.any() else float("nan"),
    }
