"""Build, load and launch the hand-written CUDA MSDA forward kernel.

The kernel (`csrc/msda_fwd.cu`) replaces the TPU kernel `_fwd_kernel`
(`uvhand_tpu/ops/msda_pallas.py:207`); its source note gives its bound. It
is compiled on first use with `nvcc` for `sm_90a` into `build/kernels/` at
the root of the checkout, as a shared library with a plain C interface, and
loaded with ctypes. Nothing is built or imported when this module is
imported, so the CPU tests can import it on a machine without `nvcc`.

`ms_deform_attn_cuda.launches` counts the kernel launches (a plain int), so
a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

import torch

_SOURCE = Path(__file__).resolve().parent / "csrc" / "msda_fwd.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the MSDA kernel")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile (once per source content) and load the kernel library."""
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"libmsda_fwd_{tag}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.msda_fwd.argtypes = [vp, vp, vp, vp, ip, ip, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.msda_fwd.restype = ci
    lib.msda_error_string.argtypes = [ci]
    lib.msda_error_string.restype = ctypes.c_char_p
    return lib


def _check(value, spatial_shapes, loc, attn):
    if not value.is_cuda:
        raise ValueError("the CUDA MSDA kernel takes CUDA tensors only")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    if attn.dtype != value.dtype:
        raise TypeError(f"attention dtype {attn.dtype} != value dtype {value.dtype}")
    if loc.dtype != torch.float32:
        raise TypeError(f"sampling locations must be float32, got {loc.dtype}")
    for name, t in (("value", value), ("sampling_locations", loc),
                    ("attention_weights", attn)):
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if value.dim() != 4:
        raise ValueError(f"value must be (B, S, M, D), got {tuple(value.shape)}")
    B, S, M, D = value.shape
    L = len(spatial_shapes)
    if S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value has S={S} tokens, spatial_shapes sum to "
                         f"{sum(h * w for h, w in spatial_shapes)}")
    if loc.dim() != 6 or tuple(loc.shape[:4]) != (B, loc.shape[1], M, L) or loc.shape[5] != 2:
        raise ValueError(f"sampling_locations must be (B, Lq, M, L, P, 2), got {tuple(loc.shape)}")
    if tuple(attn.shape) != tuple(loc.shape[:5]):
        raise ValueError(f"attention_weights must be {tuple(loc.shape[:5])}, got {tuple(attn.shape)}")


def ms_deform_attn_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream. Raises on any input the
    kernel does not take, and when the launch is refused."""
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    B, S, M, D = value.shape
    Lq, L, P = sampling_locations.shape[1], sampling_locations.shape[3], sampling_locations.shape[4]
    lib = library()
    out = torch.empty(B, Lq, M * D, dtype=value.dtype, device=value.device)
    hw = (ctypes.c_int * (2 * L))(*[int(x) for hw_ in spatial_shapes for x in hw_])
    starts, s = [], 0
    for h, w in spatial_shapes:
        starts.append(s)
        s += h * w
    level_start = (ctypes.c_int * L)(*starts)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = lib.msda_fwd(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(), hw, level_start,
        L, B, S, Lq, M, D, P, int(value.dtype == torch.bfloat16),
        value.device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"MSDA kernel launch failed: {lib.msda_error_string(err).decode()} ({err})")
    ms_deform_attn_cuda.launches += 1
    return out


ms_deform_attn_cuda.launches = 0
