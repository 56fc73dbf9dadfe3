"""xdict: a dict of prefixed keys, the reference's data container.

Port of `uvhand_tpu/utils/xdict.py` (the reference's
`arctic_tools/common/xdict.py`), on torch tensors and numpy arrays: the
JAX package's `detach` (a stop_gradient) becomes `Tensor.detach`, and
`to(device)` / `to_np()` move the tensors.
"""

from __future__ import annotations

import numpy as np
import torch


class xdict(dict):
    def subset(self, keys):
        return xdict({k: self[k] for k in keys if k in self})

    def prefix(self, pre: str) -> "xdict":
        return xdict({pre + k: v for k, v in self.items()})

    def postfix(self, post: str) -> "xdict":
        return xdict({k + post: v for k, v in self.items()})

    def search(self, keyword: str, replace_to: str | None = None) -> "xdict":
        out = xdict()
        for k, v in self.items():
            if keyword in k:
                out[k if replace_to is None else k.replace(keyword, replace_to)] = v
        return out

    def rm(self, keyword: str, keep_list=()) -> "xdict":
        return xdict({k: v for k, v in self.items() if keyword not in k or k in keep_list})

    def overwrite(self, k, v):
        assert k in self, f"overwrite: {k} not present"
        self[k] = v

    def merge(self, other):
        for k, v in other.items():
            assert k not in self, f"merge collision: {k}"
            self[k] = v
        return self

    def mul(self, scalar) -> "xdict":
        return xdict({k: (v * scalar if _is_num(v) else v) for k, v in self.items()})

    def to_np(self) -> "xdict":
        return xdict({k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                          else np.asarray(v) if _is_num(v) else v) for k, v in self.items()})

    def to(self, device) -> "xdict":
        return xdict({k: (v.to(device) if isinstance(v, torch.Tensor) else v)
                      for k, v in self.items()})

    def detach(self) -> "xdict":
        return xdict({k: (v.detach() if isinstance(v, torch.Tensor) else v)
                      for k, v in self.items()})


def _is_num(v):
    return hasattr(v, "dtype") or isinstance(v, (int, float, np.ndarray))
