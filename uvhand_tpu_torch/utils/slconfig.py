"""Python-file config loader with `_base_` inheritance and CLI overrides.

A copy of `uvhand_tpu/utils/slconfig.py` (the reference's mmcv-style
`SLConfig`, `util/slconfig.py`, and `DictAction`): configs are plain `.py`
files whose module-level variables become the config dict;
`_base_ = ["../other.py", ...]` merges parents first (children win);
`merge_from_list(["k.sub=v", ...])` applies `--options` style dotted
overrides with literal-eval semantics.
"""

from __future__ import annotations

import ast
import os.path as op
import types
from typing import Any, Dict, List


def _exec_pyfile(path: str) -> Dict[str, Any]:
    with open(path) as f:
        src = f.read()
    mod = types.ModuleType("_slconfig")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return {k: v for k, v in mod.__dict__.items()
            if not k.startswith("__") and not isinstance(v, types.ModuleType)}


def _merge(base: Dict, child: Dict) -> Dict:
    out = dict(base)
    for k, v in child.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


class SLConfig(dict):
    @classmethod
    def fromfile(cls, path: str) -> "SLConfig":
        cfg = _exec_pyfile(path)
        bases = cfg.pop("_base_", [])
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        for b in bases:
            merged = _merge(merged, cls.fromfile(op.join(op.dirname(path), b)))
        return cls(_merge(merged, cfg))

    def merge_from_list(self, options: List[str]) -> "SLConfig":
        for opt in options:
            key, _, val = opt.partition("=")
            try:
                val = ast.literal_eval(val)
            except (ValueError, SyntaxError):
                pass
            d = self
            parts = key.split(".")
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = val
        return self

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e
