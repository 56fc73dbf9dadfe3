"""Checkpoint save and restore in torch's format.

Port of `uvhand_tpu/train/checkpoint.py` (the reference's `load_resume`,
`util/settings.py`, and its per-epoch saves, `main.py`), with the same
surface:
  - `save_checkpoint` writes `{output_dir}/{epoch}/checkpoint.pth` in the
    reference's layout, `{"model": state_dict, "optimizer": ..., "step": ...,
    "epoch": ...}` (the port's parameters carry the reference's names, so
    the JAX package's `--resume x.pth` reads it through its converter), and
    `{output_dir}/{epoch}.meta.json`;
  - `load_checkpoint` restores a checkpoint directory or `.pth` with the
    `not_use_params` keyword filter (parameters whose name holds a keyword
    keep their fresh values) and restores the optimizer tolerantly (a
    mismatch keeps a fresh one); the step count comes back with the
    optimizer, so a resumed schedule continues where it stopped;
  - `load_torch_pth` reads a reference `.pth` (the parameters only);
  - `list_checkpoints` lists the epoch checkpoints of a `--resume_dir` sweep.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional, Sequence

import torch

FILE = "checkpoint.pth"


def save_checkpoint(output_dir: str, epoch: int, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None, step: int = 0,
                    extra: Optional[dict] = None) -> str:
    """Write `{output_dir}/{epoch}/checkpoint.pth` (and, with `extra`,
    `{output_dir}/{epoch}.meta.json`); returns the checkpoint directory."""
    ckpt_dir = os.path.abspath(os.path.join(output_dir, str(epoch)))
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"model": model.state_dict(),
               "optimizer": None if optimizer is None else optimizer.state_dict(),
               "step": int(step), "epoch": int(epoch)}
    path = os.path.join(ckpt_dir, FILE)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    if extra is not None:
        with open(os.path.join(output_dir, f"{epoch}.meta.json"), "w") as f:
            json.dump(extra, f, default=str)
    return ckpt_dir


def _read(path: str) -> dict:
    """The checkpoint at `path` (a checkpoint directory or a `.pth` file) as
    a dict with a "model" state dict; a bare state dict is wrapped."""
    if os.path.isdir(path):
        path = os.path.join(path, FILE)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if not (isinstance(ckpt, dict) and isinstance(ckpt.get("model"), dict)):
        ckpt = {"model": ckpt}
    return ckpt


def _load_params(model: torch.nn.Module, saved: dict,
                 not_use_params: Optional[Sequence[str]] = None) -> None:
    """Copy `saved` into `model`'s state, but for the names holding a
    `not_use_params` keyword, which keep their current values. Raises
    KeyError on a name the model needs that `saved` lacks."""
    keep = tuple(not_use_params or ())
    current = model.state_dict()
    missing = [k for k in current if k not in saved and not any(kw in k for kw in keep)]
    if missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} of the model's tensors, e.g. "
                       f"{missing[:3]}")
    model.load_state_dict({k: v if any(kw in k for kw in keep) else saved[k]
                           for k, v in current.items()})


def _optimizer_fits(optimizer: torch.optim.Optimizer, saved: Optional[dict]) -> bool:
    """True where `saved` (an optimizer state dict) has the optimizer's
    groups and, for each parameter with state, tensors of its shape."""
    if not saved or "param_groups" not in saved:
        return False
    groups = optimizer.param_groups
    if [len(g["params"]) for g in groups] != [len(g["params"]) for g in saved["param_groups"]]:
        return False
    params = [p for g in groups for p in g["params"]]
    ids = [i for g in saved["param_groups"] for i in g["params"]]
    for p, i in zip(params, ids):
        for v in saved["state"].get(i, {}).values():
            if isinstance(v, torch.Tensor) and v.dim() > 0 and v.shape != p.shape:
                return False
    return True


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    not_use_params: Optional[Sequence[str]] = None,
                    load_opt: bool = True) -> dict:
    """Restore the checkpoint at `path` (a directory of `save_checkpoint` or
    a `.pth`) into `model` and, with `load_opt`, into `optimizer`. Returns
    {"step", "epoch", "optimizer_restored"}: the saved step where the
    optimizer's state was restored, else 0 (a fresh optimizer starts its
    schedule anew, as the JAX package's tolerant restore does)."""
    ckpt = _read(path)
    _load_params(model, ckpt["model"], not_use_params)
    restored = (load_opt and optimizer is not None
                and _optimizer_fits(optimizer, ckpt.get("optimizer")))
    if restored:
        optimizer.load_state_dict(ckpt["optimizer"])
    elif load_opt and optimizer is not None:
        print(f"optimizer state of {path} does not fit this optimizer: starting it fresh")
    return {"step": int(ckpt.get("step", 0)) if restored else 0,
            "epoch": int(ckpt.get("epoch", -1)), "optimizer_restored": bool(restored)}


def load_torch_pth(path: str, model: torch.nn.Module,
                   not_use_params: Optional[Sequence[str]] = None) -> None:
    """Resume from a reference `.pth` (`{"model": state_dict, ...}` or a bare
    state dict) natively: the port's parameters carry the reference's
    names. The optimizer stays fresh; the `not_use_params` filter applies."""
    _load_params(model, _read(path)["model"], not_use_params)


def list_checkpoints(resume_dir: str):
    """All epoch checkpoints in a dir, by epoch (the `--resume_dir` sweep)."""
    out = []
    for name in os.listdir(resume_dir):
        if re.fullmatch(r"\d+", name) and os.path.isdir(os.path.join(resume_dir, name)):
            out.append((int(name), os.path.join(resume_dir, name)))
    return [p for _, p in sorted(out)]
