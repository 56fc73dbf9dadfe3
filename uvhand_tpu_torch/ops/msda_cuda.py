"""Build, load and launch the hand-written CUDA MSDA kernels.

  - `csrc/msda_fwd.cu` replaces the TPU kernel `_fwd_kernel`
    (`uvhand_tpu/ops/msda_pallas.py:207`);
  - `csrc/msda_bwd.cu` replaces both TPU backward kernels, `_bwd_kernel_sep`
    (`:233`) and `_bwd_kernel` (`:320`).

Each source note gives its kernel's bound. The sources are compiled on first
use with `nvcc` for `sm_90a`, one `nvcc` per source started together, and
linked into one shared library with a plain C interface in `build/kernels/`
at the root of the checkout, named by a hash of both sources and the flags;
it is loaded with ctypes. Nothing is built or imported when this module is
imported, so the CPU tests can import it on a machine without `nvcc`.

`ms_deform_attn_cuda.launches` and `ms_deform_attn_backward_cuda.launches`
count the kernel launches (plain ints), so a run can show that its main path
went through the kernels.
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

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "msda_fwd.cu", _CSRC / "msda_bwd.cu")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the MSDA kernels")


def _run(procs):
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile (once per source content) and load the kernel library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.read_bytes())
    so = _BUILD_DIR / f"libmsda_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, pid = _nvcc(), os.getpid()
        objs = [so.with_name(f"{src.stem}.{so.stem}.{pid}.o") for src in SOURCES]
        compile_cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(SOURCES, objs)]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True)) for cmd in compile_cmds])
        tmp = so.with_suffix(f".{pid}.tmp")
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
                *map(str, objs)]
        _run([(link, subprocess.Popen(link, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))])
        os.replace(tmp, so)
        for obj in objs:
            obj.unlink()
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.msda_fwd.argtypes = [vp, vp, vp, vp, ip, ip, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.msda_fwd.restype = ci
    lib.msda_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, ip, ip,
                             ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.msda_bwd.restype = ci
    lib.msda_error_string.argtypes = [ci]
    lib.msda_error_string.restype = ctypes.c_char_p
    return lib


def _check(value, spatial_shapes, loc, attn, grad_out=None):
    if not value.is_cuda:
        raise ValueError("the CUDA MSDA kernels take CUDA tensors only")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    if attn.dtype != value.dtype:
        raise TypeError(f"attention dtype {attn.dtype} != value dtype {value.dtype}")
    if loc.dtype != torch.float32:
        raise TypeError(f"sampling locations must be float32, got {loc.dtype}")
    named = [("value", value), ("sampling_locations", loc), ("attention_weights", attn)]
    if grad_out is not None:
        if grad_out.dtype != value.dtype:
            raise TypeError(f"grad_out dtype {grad_out.dtype} != value dtype {value.dtype}")
        named.append(("grad_out", grad_out))
    for name, t in named:
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
    if grad_out is not None and tuple(grad_out.shape) != (B, loc.shape[1], M * D):
        raise ValueError(f"grad_out must be {(B, loc.shape[1], M * D)}, got {tuple(grad_out.shape)}")


def _plan(spatial_shapes):
    L = len(spatial_shapes)
    hw = (ctypes.c_int * (2 * L))(*[int(x) for hw_ in spatial_shapes for x in hw_])
    starts, s = [], 0
    for h, w in spatial_shapes:
        starts.append(s)
        s += h * w
    return hw, (ctypes.c_int * L)(*starts)


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(
            f"MSDA {what} kernel launch failed: {lib.msda_error_string(err).decode()} ({err})")


def ms_deform_attn_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Launch the forward kernel on PyTorch's current stream. Raises on any
    input the kernel does not take, and when the launch is refused."""
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    B, S, M, D = value.shape
    Lq, L, P = sampling_locations.shape[1], sampling_locations.shape[3], sampling_locations.shape[4]
    lib = library()
    out = torch.empty(B, Lq, M * D, dtype=value.dtype, device=value.device)
    hw, level_start = _plan(spatial_shapes)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = lib.msda_fwd(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(), hw, level_start,
        L, B, S, Lq, M, D, P, int(value.dtype == torch.bfloat16),
        value.device.index, stream)
    _raise_on(lib, err, "forward")
    ms_deform_attn_cuda.launches += 1
    return out


ms_deform_attn_cuda.launches = 0


def ms_deform_attn_backward_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel on PyTorch's current stream ->
    (dvalue in the value's type, dloc float32, dattn in the attention's
    type). dvalue is summed in float32 by atomics and cast afterwards.
    Raises on any input the kernel does not take, and when the launch is
    refused."""
    _check(value, spatial_shapes, sampling_locations, attention_weights, grad_out)
    B, S, M, D = value.shape
    Lq, L, P = sampling_locations.shape[1], sampling_locations.shape[3], sampling_locations.shape[4]
    lib = library()
    dvalue = torch.zeros(B, S, M, D, dtype=torch.float32, device=value.device)
    dloc = torch.empty_like(sampling_locations)
    dattn = torch.empty_like(attention_weights)
    hw, level_start = _plan(spatial_shapes)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = lib.msda_bwd(
        value.data_ptr(), sampling_locations.data_ptr(), attention_weights.data_ptr(),
        grad_out.data_ptr(), dvalue.data_ptr(), dloc.data_ptr(), dattn.data_ptr(),
        hw, level_start, L, B, S, Lq, M, D, P, int(value.dtype == torch.bfloat16),
        value.device.index, stream)
    _raise_on(lib, err, "backward")
    ms_deform_attn_backward_cuda.launches += 1
    return dvalue.to(value.dtype), dloc, dattn


ms_deform_attn_backward_cuda.launches = 0
