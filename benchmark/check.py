"""The comparison that decides `correct`: what the timed path produced,
against the plain reference on the same inputs and weights.

Train cells: set-up drives the program's train step from the seed through
its first `check_steps` steps (the window's own call, `train_one_epoch`,
and feed, `device_prefetch`, on rows that all differ) and hands that same
step to the window. The reference follows those steps and the numbers
compared are
  - `loss_gap.<k>`: |loss_program - loss_reference| / |loss_reference| of
    step k,
  - `grad_gap`: the first gradient as the optimizer got it (the program's
    from AdamW's state after one step: exp_avg / (1 - beta1)), by the worst
    leaf: | |g_p| - |g_r| | / max(|g_r|, the median leaf's |g_r|),
  - `update_gap.1`: the parameters' change after the first step, by the
    worst leaf, alike. Adam's first step is sign-like (|lr * g / (|g| +
    eps)|), so its norm barely moves when near-zero elements flip sign,
    and moves by the factor where a group's rate is wrong,
  - `update_gap`: the parameters' change after `check_steps` steps
    (before the window moves them), by the worst leaf, alike, and
    `update_gap.median` by the median leaf.
Leaves whose reference gradient is under a thousandth of the median
leaf's (nought to rounding: a key's bias under softmax) are left out of
both leaf numbers; they move under Adam by round-off alone.

Every cell: the set-up's batches against a plain reading of the
synthetic root they were read from (`reference/data.py`): `data_gap.gt`,
the widest gap of the fields that pass through the data path unchanged,
over every row; in the val split also `data_gap.kp2d`, of the 2D fields
in the crop, over every row, and `data_gap.image`, of the crop itself,
over `IMAGE_ROWS` rows drawn from the seed.

Eval cells: every batch the window served is compared, row by row, with
the reference's rows of the same batch: `row_gap.<metric>` is the widest
|program - reference| over the window's rows, over the median |reference|
of that metric; a row missing, or NaN on one side only, reads inf.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

GRAD_FLOOR = 1e-3
IMAGE_ROWS = 16


def rel(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = sorted(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].float()) for n in names])
    return dict(zip(names, norms.tolist()))


def worst_leaf(program: Dict[str, float], reference: Dict[str, float],
               leaves: List[str]) -> float:
    """max over `leaves` of | |p| - |r| | / max(|r|, the median leaf's |r|)."""
    gaps = leaf_gaps(program, reference, leaves)
    return max(gaps.values()) if gaps else math.inf


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    med = float(np.median([reference[n] for n in leaves]))
    return {n: abs(program[n] - reference[n]) / max(reference[n], med, 1e-30) for n in leaves}


def moved_leaves(ref_grads: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least GRAD_FLOOR of the
    median leaf's."""
    med = float(np.median(list(ref_grads.values())))
    return sorted(n for n, g in ref_grads.items() if g >= GRAD_FLOOR * med)


def train_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """`program` / `reference`: {"losses": [...], "grad": {leaf: norm},
    "update1": {leaf: norm}, "update": {leaf: norm}}."""
    out = {f"loss_gap.{k + 1}": rel(p, r)
           for k, (p, r) in enumerate(zip(program["losses"], reference["losses"]))}
    leaves = moved_leaves(reference["grad"])
    out["grad_gap"] = worst_leaf(program["grad"], reference["grad"], leaves)
    out["update_gap.1"] = worst_leaf(program["update1"], reference["update1"], leaves)
    out["update_gap"] = worst_leaf(program["update"], reference["update"], leaves)
    out["update_gap.median"] = float(np.median(list(
        leaf_gaps(program["update"], reference["update"], leaves).values())))
    return out


def worst_leaves(program: dict, reference: dict, key: str, k: int = 6) -> list:
    """The `k` leaves with the widest gap of `key` ("grad", "update1" or
    "update"):
    [name, gap, program's norm, reference's norm, reference's gradient]."""
    leaves = moved_leaves(reference["grad"])
    gaps = leaf_gaps(program[key], reference[key], leaves)
    top = sorted(gaps, key=lambda n: -gaps[n])[:k]
    return [[n, gaps[n], program[key][n], reference[key][n], reference["grad"][n]] for n in top]


def eval_numbers(program_rows: List[Dict[str, np.ndarray]], batch_ids: List[int],
                 reference_rows: Dict[int, Dict[str, np.ndarray]]) -> Dict[str, float]:
    """`program_rows[i]`: {metric: (B,)} of the window's i-th batch, which
    was set-up batch `batch_ids[i]`; `reference_rows[id]` the reference's."""
    metrics = sorted(next(iter(reference_rows.values())))
    scale = {}
    for m in metrics:
        ref = np.concatenate([r[m] for r in reference_rows.values()])
        finite = np.abs(ref[np.isfinite(ref)])
        scale[m] = float(np.median(finite)) if finite.size else 1.0
    out = {f"row_gap.{m}": 0.0 for m in metrics}
    for rows, i in zip(program_rows, batch_ids):
        ref = reference_rows[i]
        for m in metrics:
            key = f"row_gap.{m}"
            p = rows.get(m)
            if p is None or p.shape != ref[m].shape:
                out[key] = math.inf
                continue
            nan_p, nan_r = ~np.isfinite(p), ~np.isfinite(ref[m])
            if (nan_p != nan_r).any():
                out[key] = math.inf
                continue
            ok = ~nan_r
            if ok.any():
                gap = float(np.max(np.abs(p[ok] - ref[m][ok]))) / max(scale[m], 1e-30)
                out[key] = max(out[key], gap)
    return out


def data_numbers(batches: List[dict], path: str, split: str, img_res: int, seed: int
                 ) -> Dict[str, float]:
    """The set-up's batches against the plain reading of the root at `path`."""
    from .reference import data

    rng = np.random.default_rng(seed)
    rows = [(b, r) for b in range(len(batches)) for r in range(len(batches[b]["images"]))]
    pick = rng.choice(len(rows), size=min(IMAGE_ROWS, len(rows)), replace=False)
    gaps = data.gaps(batches, path, split, img_res, {rows[i] for i in pick})
    return {f"data_gap.{k}": v for k, v in gaps.items()}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}) for every number with a limit;
    a limit with no number fails."""
    checks, correct = {}, bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        checks[name] = {"value": value, "limit": limit}
        correct = correct and math.isfinite(value) and value <= limit
    return correct, checks
