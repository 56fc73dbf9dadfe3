"""Build, load and launch the hand-written CUDA MSDA kernels.

  - `csrc/msda_fwd.cu` replaces the TPU kernel `_fwd_kernel`
    (`uvhand_tpu/ops/msda_pallas.py:207`);
  - `csrc/msda_bwd.cu` replaces both TPU backward kernels, `_bwd_kernel_sep`
    (`:233`) and `_bwd_kernel` (`:320`);
  - `csrc/msda_fac_fwd.cu` replaces the factorized forward `_fwd_kernel_fac`
    (`:388`), and `csrc/msda_fac_bwd.cu` its backward `_bwd_kernel_fac`
    (`:429`);
    each of the four holds a staged kernel, which keeps the (batch, head)
    value slab in shared memory (the backwards: one level of it), and a
    general kernel that gathers from global memory; `staged_plan` picks
    one from the shapes before the launch, the same plan for both forms.
    The general kernels also take float64 (both forms) and float16 (the
    factorized form) values, and, in the factorized form, float32
    attention with a bfloat16 or float16 value; the staged ones take
    float32 or bfloat16, one type for value and attention.

and the research scripts' TPU kernels (`uvhand_tpu_torch/scripts/`):
  - `csrc/msda_bwd.cu`'s entry `msda_ablate_bwd` and `csrc/msda_onlyg.cu`
    replace the ablation kernel `kernel` of `scripts/bench_msda_ablation.py`
    (`:1064`), and `csrc/msda_xdot.cu` its `kernel_xdot` (`:1022`);
  - `csrc/probe_lane_slice.cu` replaces `scripts/probe_dynamic_lane_slice.py`'s
    kernel (`:32`), `csrc/probe_gather.cu` those of
    `scripts/repro_dynamic_gather.py` (`:23`) and `scripts/probe_gather_scale.py`
    (`:19`).

Each source note gives its kernel's bound. The sources (and the helpers they
share, `csrc/msda_common.cuh`) are compiled on first use with `nvcc` for
`sm_90a`, one `nvcc` per source started together, and linked into one shared
library with a plain C interface in `build/kernels/` at the root of the
checkout, named by a hash of the sources and the flags; it is loaded with
ctypes. Nothing is built or imported when this module is imported, so the
CPU tests can import it on a machine without `nvcc`.

Each wrapper's `.launches` counts its kernel's launches (a plain int), so a
run can show that its main path went through the kernels; the forwards',
backwards' and ablation's wrappers count every launch, and `FWD_STAGED`,
`FWD_GENERAL`, `BWD_STAGED`, `BWD_GENERAL`, `FAC_FWD_STAGED`,
`FAC_FWD_GENERAL`, `FAC_BWD_STAGED`, `FAC_BWD_GENERAL`, `ABLATE_STAGED`,
`ABLATE_GENERAL` count them by kernel. The compiler's report of each
kernel's registers, shared memory and spills (`-Xptxas -v`) is kept beside
the library (`ptxas_report()`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = tuple(_CSRC / f"{name}.cu" for name in
                ("msda_fwd", "msda_bwd", "msda_fac_fwd", "msda_fac_bwd", "msda_onlyg",
                 "msda_xdot", "probe_lane_slice", "probe_gather"))
HEADERS = (_CSRC / "msda_common.cuh",)
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
#: the dynamic shared memory one block may opt into on an H100 (sm_90)
SMEM_LIMIT = 232_448
#: the C entries' codes of the value and attention types (`TypeCode` in
#: csrc/msda_common.cuh)
TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.float64: 3}
#: the value types the kernels take: the staged kernels (and the research
#: kernels) float32 and bfloat16; the gather form's general kernels float64
#: too; the factorized form's general kernels float16 too
STAGED_TYPES = (torch.float32, torch.bfloat16)
GATHER_TYPES = STAGED_TYPES + (torch.float64,)
FAC_TYPES = GATHER_TYPES + (torch.float16,)


class StagedPlan(NamedTuple):
    """How a staged kernel runs one call: the levels each block stages
    (one group: every level, for the forward; one level a group, for the
    backward) and the dynamic shared memory of a block in bytes."""
    groups: Tuple[Tuple[int, ...], ...]
    smem: int


def staged_plan(spatial_shapes: Sequence[Tuple[int, int]], D: int, dtype: torch.dtype,
                backward: bool = False) -> Optional[StagedPlan]:
    """The staged kernel's plan for these shapes, or None where the general
    kernel runs; one plan for the gather and the factorized kernels, whose
    staged kernels share a layout. The staged kernels take float32 or
    bfloat16 rows of D = 8,
    16 or 32 channels (8-lane groups, each lane D / 8 channels; rows of
    whole 16-byte chunks, as cp.async copies 16 bytes), and a block's slab
    within SMEM_LIMIT. The forward stages the (b, m) value slab of every
    level (S * D values); the backward one level of it a block, so its
    blocks all do the same work (Lq * P points each) and its shared memory
    is the largest level's value rows."""
    if dtype not in STAGED_TYPES:
        return None
    size = 4 if dtype == torch.float32 else 2
    if D not in (8, 16, 32):
        return None
    cells = [int(h) * int(w) for h, w in spatial_shapes]
    if backward:
        groups = tuple((lvl,) for lvl in range(len(cells)))
        smem = max(cells) * D * size
    else:
        groups = (tuple(range(len(cells))),)
        smem = sum(cells) * D * size
    return StagedPlan(groups, smem) if 0 < smem <= SMEM_LIMIT else None


class LaunchCount:
    """A kernel's launch count, `.launches` (a plain int)."""

    def __init__(self):
        self.launches = 0


FWD_STAGED, FWD_GENERAL = LaunchCount(), LaunchCount()
BWD_STAGED, BWD_GENERAL = LaunchCount(), LaunchCount()
FAC_FWD_STAGED, FAC_FWD_GENERAL = LaunchCount(), LaunchCount()
FAC_BWD_STAGED, FAC_BWD_GENERAL = LaunchCount(), LaunchCount()
ABLATE_STAGED, ABLATE_GENERAL = LaunchCount(), LaunchCount()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the MSDA kernels")


def _run(procs):
    """Wait for each (cmd, process); raise on a failure; return what the
    processes wrote to stderr."""
    logs = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
        logs.append(err)
    return "".join(logs)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile (once per source content) and load the kernel library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        digest.update(src.read_bytes())
    so = _BUILD_DIR / f"libmsda_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, pid = _nvcc(), os.getpid()
        objs = [so.with_name(f"{src.stem}.{so.stem}.{pid}.o") for src in SOURCES]
        compile_cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(SOURCES, objs)]
        report = _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.PIPE, text=True))
                       for cmd in compile_cmds])
        so.with_suffix(".ptxas.txt").write_text(report)
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
    lib.msda_fwd_staged.argtypes = [vp, vp, vp, vp, ip, ip, ci, ci, ci, ci, ci, ci, ci, ci, ci,
                                    ci, vp]
    lib.msda_fwd_staged.restype = ci
    lib.msda_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, ip, ip,
                             ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.msda_bwd.restype = ci
    lib.msda_bwd_staged.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ip, ip,
                                    ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.msda_bwd_staged.restype = ci
    for gather, fac in (("msda_fwd", "msda_fac_fwd"), ("msda_bwd", "msda_fac_bwd")):
        for suffix in ("", "_staged"):
            # the factorized entries take the attention's type code after the value's
            argtypes = getattr(lib, gather + suffix).argtypes
            getattr(lib, fac + suffix).argtypes = argtypes[:-2] + [ci] + argtypes[-2:]
            getattr(lib, fac + suffix).restype = ci
    lib.msda_ablate_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ip, ip,
                                    ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.msda_ablate_bwd.restype = ci
    lib.msda_onlyg.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.msda_onlyg.restype = ci
    lib.msda_xdot.argtypes = [vp, vp, vp, vp, vp, vp, vp, ip, ip,
                              ci, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.msda_xdot.restype = ci
    lib.probe_lane_slice.argtypes = [vp, vp, ci, ci, ci, ci, vp]
    lib.probe_lane_slice.restype = ci
    lib.probe_gather.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.probe_gather.restype = ci
    lib.msda_error_string.argtypes = [ci]
    lib.msda_error_string.restype = ctypes.c_char_p
    lib.ptxas_report = so.with_suffix(".ptxas.txt")
    return lib


def ptxas_report() -> str:
    """What `-Xptxas -v` said of every kernel when the library was built
    (registers, shared memory, spills), or "" if no report was kept."""
    path = library().ptxas_report
    return path.read_text() if path.exists() else ""


def _check(value, spatial_shapes, loc, attn, grad_out=None, types=STAGED_TYPES, mixed=False):
    if value.dim() != 4:
        raise ValueError(f"value must be (B, S, M, D), got {tuple(value.shape)}")
    B, S, M, D = value.shape
    _check_samples(("value", value), spatial_shapes, loc, attn, B, M, S,
                   [] if grad_out is None else [("grad_out", grad_out)], types, mixed)
    if grad_out is not None and tuple(grad_out.shape) != (B, loc.shape[1], M * D):
        raise ValueError(f"grad_out must be {(B, loc.shape[1], M * D)}, got {tuple(grad_out.shape)}")


def _check_samples(lead, spatial_shapes, loc, attn, B, M, S, more=(), types=STAGED_TYPES,
                   mixed=False):
    """The checks every MSDA wrapper shares: `lead` (name, tensor) on the
    card in one of `types`, `more` in its type, the attention in its type
    or, where `mixed`, float32 with a bfloat16 or float16 lead, the
    locations float32 (float64 with a float64 lead), all on one device and
    contiguous; S tokens in the levels; locations (B, Lq, M, L, P, 2) and
    attention (B, Lq, M, L, P)."""
    lead_name, first = lead
    if not first.is_cuda:
        raise ValueError("the CUDA MSDA kernels take CUDA tensors only")
    check_types(lead, loc, attn, more, types, mixed)
    named = [lead, ("attention_weights", attn), *more]
    for name, t in named + [("sampling_locations", loc)]:
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, {lead_name} on {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    L = len(spatial_shapes)
    if S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"{lead_name} has S={S} tokens, spatial_shapes sum to "
                         f"{sum(h * w for h, w in spatial_shapes)}")
    if loc.dim() != 6 or tuple(loc.shape[:4]) != (B, loc.shape[1], M, L) or loc.shape[5] != 2:
        raise ValueError(f"sampling_locations must be (B, Lq, M, L, P, 2), got {tuple(loc.shape)}")
    if tuple(attn.shape) != tuple(loc.shape[:5]):
        raise ValueError(f"attention_weights must be {tuple(loc.shape[:5])}, got {tuple(attn.shape)}")


def check_types(lead, loc, attn, more=(), types=STAGED_TYPES, mixed=False):
    """The type checks of `_check_samples` (see there), on any device."""
    lead_name, first = lead
    if first.dtype not in types:
        raise TypeError(f"{lead_name} must be one of {', '.join(map(str, types))}, "
                        f"got {first.dtype}")
    loc_type = torch.float64 if first.dtype == torch.float64 else torch.float32
    if loc.dtype != loc_type:
        raise TypeError(f"sampling locations must be {loc_type}, got {loc.dtype}")
    if attn.dtype != first.dtype and not (
            mixed and attn.dtype == torch.float32
            and first.dtype in (torch.bfloat16, torch.float16)):
        raise TypeError(f"attention_weights dtype {attn.dtype} != {lead_name} dtype {first.dtype}")
    for name, t in more:
        if t.dtype != first.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != {lead_name} dtype {first.dtype}")


def _plan(spatial_shapes):
    L = len(spatial_shapes)
    hw = (ctypes.c_int * (2 * L))(*[int(x) for hw_ in spatial_shapes for x in hw_])
    starts, s = [], 0
    for h, w in spatial_shapes:
        starts.append(s)
        s += h * w
    return hw, (ctypes.c_int * L)(*starts)


def _raise_on(lib, err, what, invalid=""):
    """Raise on a launch's error code; `invalid` says what the kernel's C
    entry refuses as an invalid value (cudaErrorInvalidValue)."""
    if err != 0:
        why = f": {invalid}" if invalid and err == 1 else ""
        raise RuntimeError(f"MSDA {what} kernel launch failed: "
                           f"{lib.msda_error_string(err).decode()} ({err}){why}")


def _pick(kernel, plan):
    """The plan to launch with under `kernel` ('auto': the staged kernel
    where there is a plan; 'staged'; 'general'), None for the general one."""
    if kernel == "general":
        return None
    if kernel == "staged" and plan is None:
        raise ValueError("these shapes have no staged plan (see staged_plan)")
    if kernel not in ("auto", "staged"):
        raise ValueError(f"unknown MSDA kernel {kernel!r}")
    return plan


def _staged_args(value, plan):
    """The staged entries' extra argument, the block's shared-memory bytes;
    none for a general entry. The staged kernels copy the value by 16-byte
    chunks."""
    if plan is None:
        return ()
    if value.data_ptr() % 16:
        raise ValueError("the staged MSDA kernels copy the value by 16-byte chunks: its data "
                         "must be 16-byte aligned")
    return (plan.smem,)


def _type_args(value, attn, fac):
    """The entries' type codes: the value's, and the factorized entries'
    attention's after it."""
    return (TYPE_CODE[value.dtype],) + ((TYPE_CODE[attn.dtype],) if fac else ())


def _launch_forward(entry, what, value, spatial_shapes, loc, attn, plan=None, fac=False):
    """Launch a forward entry; `plan` (a StagedPlan) for a staged one."""
    _check(value, spatial_shapes, loc, attn, types=FAC_TYPES if fac else GATHER_TYPES,
           mixed=fac)
    B, S, M, D = value.shape
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    staged = _staged_args(value, plan)
    lib = library()
    out = torch.empty(B, Lq, M * D, dtype=value.dtype, device=value.device)
    hw, level_start = _plan(spatial_shapes)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = getattr(lib, entry)(
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(), hw, level_start,
        L, B, S, Lq, M, D, P, *staged, *_type_args(value, attn, fac), value.device.index,
        stream)
    _raise_on(lib, err, what)
    return out


def _launch_backward(entry, what, value, spatial_shapes, loc, attn, grad_out, plan=None,
                     fac=False):
    """Launch a backward entry; `plan` (a StagedPlan) for a staged one, which
    writes every dvalue row in the value's type itself. A general one adds
    into a zeroed dvalue in the arithmetic type (float32, or float64 for a
    float64 value), cast to the value's type afterwards."""
    _check(value, spatial_shapes, loc, attn, grad_out,
           types=FAC_TYPES if fac else GATHER_TYPES, mixed=fac)
    B, S, M, D = value.shape
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    staged = _staged_args(value, plan)
    lib = library()
    if staged:
        # float32 sums: in dvalue itself, or in scratch that the kernel
        # rounds into a bfloat16 dvalue
        dvalue = torch.empty(B, S, M, D, dtype=value.dtype, device=value.device)
        sums = [dvalue if value.dtype == torch.float32
                else torch.empty_like(dvalue, dtype=torch.float32)]
    else:
        dvalue = torch.zeros(B, S, M, D, dtype=loc.dtype, device=value.device)
        sums = []
    dloc = torch.empty_like(loc)
    dattn = torch.empty_like(attn)
    hw, level_start = _plan(spatial_shapes)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = getattr(lib, entry)(
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(), grad_out.data_ptr(),
        dvalue.data_ptr(), *(t.data_ptr() for t in sums), dloc.data_ptr(), dattn.data_ptr(),
        hw, level_start, L, B, S, Lq, M, D, P, *staged, *_type_args(value, attn, fac),
        value.device.index, stream)
    _raise_on(lib, err, what)
    return dvalue.to(value.dtype), dloc, dattn


def _dispatch(launch, entries, counts, what, value, spatial_shapes, loc, attn, *args,
              kernel="auto", backward=False, fac=False):
    """One launch of an op with a staged and a general kernel: the staged
    one where `staged_plan` has a plan for these shapes and the attention
    is in the value's type, else the general one (`kernel` 'staged' or
    'general' picks one). `entries` and `counts` are (general, staged)."""
    plan = staged_plan(spatial_shapes, value.shape[-1], value.dtype, backward=backward)
    plan = _pick(kernel, plan if attn.dtype == value.dtype else None)
    staged = plan is not None
    out = launch(entries[staged], ("staged " if staged else "") + what, value, spatial_shapes,
                 loc, attn, *args, plan=plan, fac=fac)
    counts[staged].launches += 1
    return out


def ms_deform_attn_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    kernel: str = "auto",
) -> torch.Tensor:
    """Launch the forward kernel on PyTorch's current stream: the staged one
    where `staged_plan` has a plan for these shapes, else the general one
    (`kernel` 'staged' or 'general' picks one, to hold them against each
    other). Value and attention of one type of `GATHER_TYPES` (float64:
    the general kernel, float64 locations). Raises on any input the kernel
    does not take, and when the launch is refused."""
    out = _dispatch(_launch_forward, ("msda_fwd", "msda_fwd_staged"), (FWD_GENERAL, FWD_STAGED),
                    "forward", value, spatial_shapes, sampling_locations, attention_weights,
                    kernel=kernel)
    ms_deform_attn_cuda.launches += 1
    return out


ms_deform_attn_cuda.launches = 0


def ms_deform_attn_backward_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,
    kernel: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel on PyTorch's current stream: the staged one
    where `staged_plan(..., backward=True)` has a plan, else the general one
    (`kernel` as for `ms_deform_attn_cuda`) -> (dvalue in the value's type,
    dloc in the locations' type, dattn in the attention's type). dvalue is
    summed in float32 (float64 for a float64 value) by atomics and rounded
    once to the value's type. Raises on any input the kernel does not take,
    and when the launch is refused."""
    grads = _dispatch(_launch_backward, ("msda_bwd", "msda_bwd_staged"),
                      (BWD_GENERAL, BWD_STAGED), "backward", value, spatial_shapes,
                      sampling_locations, attention_weights, grad_out, kernel=kernel,
                      backward=True)
    ms_deform_attn_backward_cuda.launches += 1
    return grads


ms_deform_attn_backward_cuda.launches = 0


def ms_deform_attn_fac_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    kernel: str = "auto",
) -> torch.Tensor:
    """Launch the factorized forward kernel (`msda_fac_fwd.cu`) on
    PyTorch's current stream, staged or general as `ms_deform_attn_cuda`
    chooses; as `ms_deform_attn_cuda` otherwise. The value may also be
    float16 (`FAC_TYPES`), and with a bfloat16 or float16 value the
    attention float32 (the general kernel, which widens it on read)."""
    out = _dispatch(_launch_forward, ("msda_fac_fwd", "msda_fac_fwd_staged"),
                    (FAC_FWD_GENERAL, FAC_FWD_STAGED), "factorized forward", value,
                    spatial_shapes, sampling_locations, attention_weights, kernel=kernel,
                    fac=True)
    ms_deform_attn_fac_cuda.launches += 1
    return out


ms_deform_attn_fac_cuda.launches = 0


def ms_deform_attn_fac_backward_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,
    kernel: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the factorized backward kernel (`msda_fac_bwd.cu`) on
    PyTorch's current stream, staged or general as
    `ms_deform_attn_backward_cuda` chooses; as it otherwise (dvalue summed
    in float32, or float64, by atomics, not deterministic), with the types
    of `ms_deform_attn_fac_cuda`."""
    grads = _dispatch(_launch_backward, ("msda_fac_bwd", "msda_fac_bwd_staged"),
                      (FAC_BWD_GENERAL, FAC_BWD_STAGED), "factorized backward", value,
                      spatial_shapes, sampling_locations, attention_weights, grad_out,
                      kernel=kernel, backward=True, fac=True)
    ms_deform_attn_fac_backward_cuda.launches += 1
    return grads


ms_deform_attn_fac_backward_cuda.launches = 0


#: the ablation backward's output masks and gates, by the codes of
#: `msda_ablate_bwd` (csrc/msda_bwd.cu)
ABLATE_OUT = {"full": 0, "nodpy": 1, "nodaw": 2, "nodv": 3}
ABLATE_GATE = {"where": 0, "eq": 1}


def _pixel_grads(loc):
    """dpy, dpx, daw: float32 (B, Lq, M, L, P), every entry written by the kernel."""
    return tuple(torch.empty(loc.shape[:5], dtype=torch.float32, device=loc.device)
                 for _ in range(3))


def ms_deform_attn_ablate_backward_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,
    out: str = "full",
    gate: str = "where",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the ablation of the backward kernel (`msda_ablate_bwd`) ->
    (dvalue (B, S, M, D) float32, dpy, dpx, daw (B, Lq, M, L, P) float32 in
    pixel space). `out` drops one output's work ('full', 'nodpy', 'nodaw',
    'nodv'); `gate` is 'where' (the production gate) or 'eq'. The body is
    the staged backward's where `staged_plan(..., backward=True)` has a
    plan, else the general one's, as in `ms_deform_attn_backward_cuda`.
    dvalue is summed by float32 atomics, not deterministic. Raises on any
    input the kernel does not take, and when the launch is refused."""
    if out not in ABLATE_OUT or gate not in ABLATE_GATE:
        raise ValueError(f"unknown ablation out={out!r} or gate={gate!r}")
    _check(value, spatial_shapes, sampling_locations, attention_weights, grad_out)
    B, S, M, D = value.shape
    loc = sampling_locations
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    plan = staged_plan(spatial_shapes, D, value.dtype, backward=True)
    smem = _staged_args(value, plan)
    lib = library()
    # the staged body writes every dvalue row; the general one adds into zeros
    dvalue = (torch.empty if smem else torch.zeros)(B, S, M, D, dtype=torch.float32,
                                                    device=value.device)
    dpy, dpx, daw = _pixel_grads(loc)
    hw, level_start = _plan(spatial_shapes)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = lib.msda_ablate_bwd(
        value.data_ptr(), loc.data_ptr(), attention_weights.data_ptr(), grad_out.data_ptr(),
        dvalue.data_ptr(), dpy.data_ptr(), dpx.data_ptr(), daw.data_ptr(), hw, level_start,
        L, B, S, Lq, M, D, P, ABLATE_OUT[out], ABLATE_GATE[gate], *(smem or (0,)),
        int(value.dtype == torch.bfloat16), value.device.index, stream)
    _raise_on(lib, err, "ablation backward")
    (ABLATE_STAGED if smem else ABLATE_GENERAL).launches += 1
    ms_deform_attn_ablate_backward_cuda.launches += 1
    return dvalue, dpy, dpx, daw


ms_deform_attn_ablate_backward_cuda.launches = 0


def ms_deform_attn_onlyg_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the dense `onlyg` kernel (`csrc/msda_onlyg.cu`) -> (dvalue
    float32, dpy = 0, dpx = 0, daw float32), as the plain version
    `msda_ablation.onlyg_torch`. Level 0 must hold at least L * P tokens.
    Raises on any input the kernel does not take, and when the launch is
    refused."""
    _check(value, spatial_shapes, sampling_locations, attention_weights, grad_out)
    B, S, M, D = value.shape
    loc = sampling_locations
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    h0, w0 = spatial_shapes[0]
    if h0 * w0 < L * P:
        raise ValueError(f"onlyg reads daw off level 0's first L*P = {L * P} tokens; "
                         f"level 0 has {h0 * w0}")
    lib = library()
    dvalue = torch.empty(B, S, M, D, dtype=torch.float32, device=value.device)
    daw = torch.empty(loc.shape[:5], dtype=torch.float32, device=value.device)
    dpy = torch.zeros_like(daw)
    dpx = torch.zeros_like(daw)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = lib.msda_onlyg(value.data_ptr(), grad_out.data_ptr(), dvalue.data_ptr(),
                         daw.data_ptr(), B, S, Lq, M, D, L * P,
                         int(value.dtype == torch.bfloat16), value.device.index, stream)
    _raise_on(lib, err, "onlyg", f"its shared-memory tiles take D <= 116, got D={D}")
    ms_deform_attn_onlyg_cuda.launches += 1
    return dvalue, dpy, dpx, daw


ms_deform_attn_onlyg_cuda.launches = 0


def ms_deform_attn_xdot_cuda(
    G: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the `xdot` kernel (`csrc/msda_xdot.cu`) on the dense plane G
    (B*M, Lq, S) in the attention's type -> (dpy, dpx, daw float32
    (B, Lq, M, L, P) in pixel space, ws (B*M, Lq, S) in G's type), as the
    plain version `msda_ablation.xdot_torch`. Raises on any input the kernel
    does not take, and when the launch is refused."""
    loc, attn = sampling_locations, attention_weights
    if G.dim() != 3 or loc.dim() != 6:
        raise ValueError(f"G must be (B*M, Lq, S) and sampling_locations (B, Lq, M, L, P, 2), "
                         f"got {tuple(G.shape)} and {tuple(loc.shape)}")
    B, Lq, M, L, P = loc.shape[:5]
    S = G.shape[2]
    _check_samples(("G", G), spatial_shapes, loc, attn, B, M, S)
    if tuple(G.shape) != (B * M, Lq, S):
        raise ValueError(f"G must be {(B * M, Lq, S)}, got {tuple(G.shape)}")
    lib = library()
    dpy, dpx, daw = _pixel_grads(loc)
    ws = torch.empty_like(G)
    hw, level_start = _plan(spatial_shapes)
    stream = torch.cuda.current_stream(G.device).cuda_stream
    err = lib.msda_xdot(G.data_ptr(), loc.data_ptr(), attn.data_ptr(), dpy.data_ptr(),
                        dpx.data_ptr(), daw.data_ptr(), ws.data_ptr(), hw, level_start,
                        L, B, S, Lq, M, P, int(G.dtype == torch.bfloat16), G.device.index,
                        stream)
    _raise_on(lib, err, "xdot", f"it keeps a row of S floats in shared memory: S <= 12288, "
                                f"got S={S}")
    ms_deform_attn_xdot_cuda.launches += 1
    return dpy, dpx, daw, ws


ms_deform_attn_xdot_cuda.launches = 0


def _check_probe(named, dtypes):
    for (name, t), dtype in zip(named, dtypes):
        if not t.is_cuda:
            raise ValueError("the CUDA probe kernels take CUDA tensors only")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != named[0][1].device:
            raise ValueError(f"{name} is on {t.device}, {named[0][0]} on {named[0][1].device}")


def lane_slice_cuda(x: torch.Tensor, M: int, W: int) -> torch.Tensor:
    """Launch the lane-slice probe (`csrc/probe_lane_slice.cu`): x (Q, M*W)
    float32 -> out (M*Q, W), out[m*Q + q, w] = 2 * x[q, m*W + w], as the
    plain version `probes.lane_slice_torch`. Raises on any input the kernel
    does not take, and when the launch is refused."""
    _check_probe([("x", x)], [torch.float32])
    if x.dim() != 2 or x.shape[1] != M * W:
        raise ValueError(f"x must be (Q, M*W) = (Q, {M * W}), got {tuple(x.shape)}")
    Q = x.shape[0]
    lib = library()
    out = torch.empty(M * Q, W, dtype=torch.float32, device=x.device)
    err = lib.probe_lane_slice(x.data_ptr(), out.data_ptr(), Q, M, W, x.device.index,
                               torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "lane-slice probe")
    lane_slice_cuda.launches += 1
    return out


lane_slice_cuda.launches = 0


def take_along_axis_cuda(v: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """Launch the gather probe (`csrc/probe_gather.cu`):
    `take_along_axis(v, idx, axis)` for float32 v and int32 idx of one shape,
    2-D (axis 0 or 1) or 3-D (axis 1 or 2, negative axes counted from the
    end), as the plain version `probes.take_along_axis_torch`. Indices must
    be in range (out of range gives NaN). Raises on any input the kernel
    does not take, and when the launch is refused."""
    _check_probe([("v", v), ("idx", idx)], [torch.float32, torch.int32])
    if v.dim() not in (2, 3) or idx.shape != v.shape:
        raise ValueError(f"v and idx must share one 2-D or 3-D shape, got {tuple(v.shape)} "
                         f"and {tuple(idx.shape)}")
    ax = axis % v.dim() + (3 - v.dim())  # the axis of the (N, R, C) view
    if ax not in (1, 2):
        raise ValueError(f"axis {axis} of a {v.dim()}-D array: the kernel gathers along the "
                         f"last two axes")
    N, R, C = (1,) * (3 - v.dim()) + tuple(v.shape)
    lib = library()
    out = torch.empty_like(v)
    err = lib.probe_gather(v.data_ptr(), idx.data_ptr(), out.data_ptr(), N, R, C, ax,
                           v.device.index, torch.cuda.current_stream(v.device).cuda_stream)
    _raise_on(lib, err, "gather probe")
    take_along_axis_cuda.launches += 1
    return out


take_along_axis_cuda.launches = 0
