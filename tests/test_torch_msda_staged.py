"""The staged MSDA kernels' plan (`msda_cuda.staged_plan`), the wrappers'
choice between the staged and the general kernel, and the level-group
decomposition the staged backwards rely on, on the CPU.

The staged backwards (`csrc/msda_bwd.cu`, `msda_bwd_staged_kernel`, and
`csrc/msda_fac_bwd.cu`, `msda_fac_bwd_staged_kernel`) run one block per
(batch, head, level group) and never sum between blocks. That is right
because a group's dattn and dloc depend only on its own value rows, and its
value rows' dvalue only on its own points: the plain backward
(`ms_deform_attn_torch_backward`, `ms_deform_attn_fac_torch_backward`) on a
group's sub-problem (its levels' value rows, locations and attention, the
whole incoming gradient) gives exactly the whole call's dattn, dloc and
those dvalue rows. Tolerance: none (bit for bit): the sub-problem repeats
the same float32 operations in the same order. The kernels themselves run
only on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

import numpy as np
import pytest
import torch

from uvhand_tpu_torch.ops import msda_cuda
from uvhand_tpu_torch.ops.msda import (fac_ok, ms_deform_attn_fac_torch_backward,
                                       ms_deform_attn_torch_backward)
from uvhand_tpu_torch.ops.msda_cuda import SMEM_LIMIT, StagedPlan, staged_plan

ARCTIC = ((28, 28), (14, 14), (7, 7), (4, 4))  # arctic_sf's levels at 224x224
SIDE = ((4, 200), (150, 3))  # a side over 128


def arctic_inputs(lo, hi, dtype, seed=0, b=2, lq=40, m=2, d=8, p=4):
    rng = np.random.default_rng(seed)
    S, L = sum(h * w for h, w in ARCTIC), len(ARCTIC)
    value = torch.from_numpy(rng.standard_normal((b, S, m, d)).astype(np.float32)).to(dtype)
    loc = torch.from_numpy(rng.uniform(lo, hi, (b, lq, m, L, p, 2)).astype(np.float32))
    logits = rng.standard_normal((b, lq, m, L * p))
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    attn = torch.from_numpy(attn.reshape(b, lq, m, L, p).astype(np.float32)).to(dtype)
    grad = torch.from_numpy(rng.standard_normal((b, lq, m * d)).astype(np.float32)).to(dtype)
    return value, loc, attn, grad


def assert_level_groups_give_the_whole(backward, lo, hi, dtype):
    value, loc, attn, grad = arctic_inputs(lo, hi, dtype)
    dvalue, dloc, dattn = backward(value, ARCTIC, loc, attn, grad)
    plan = staged_plan(ARCTIC, 32, dtype, backward=True)
    starts = np.cumsum([0] + [h * w for h, w in ARCTIC])
    covered = []
    for group in plan.groups:
        shapes = tuple(ARCTIC[lvl] for lvl in group)
        rows = slice(int(starts[group[0]]), int(starts[group[-1] + 1]))
        lv = slice(group[0], group[-1] + 1)
        sub = backward(value[:, rows].contiguous(), shapes, loc[:, :, :, lv].contiguous(),
                       attn[:, :, :, lv].contiguous(), grad)
        assert torch.equal(sub[0], dvalue[:, rows])
        assert torch.equal(sub[1], dloc[:, :, :, lv])
        assert torch.equal(sub[2], dattn[:, :, :, lv])
        covered += list(group)
    assert covered == list(range(len(ARCTIC)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.0, 3.0)], ids=["in_range", "out_of_range"])
def test_level_groups_give_the_whole_backward(lo, hi, dtype):
    assert_level_groups_give_the_whole(ms_deform_attn_torch_backward, lo, hi, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.0, 3.0)], ids=["in_range", "out_of_range"])
def test_level_groups_give_the_whole_fac_backward(lo, hi, dtype):
    """The factorized backward's rounding points sit inside each (level,
    point), so its levels split as the gather form's do."""
    assert_level_groups_give_the_whole(ms_deform_attn_fac_torch_backward, lo, hi, dtype)


@pytest.mark.parametrize("shapes,D,dtype,fwd,bwd", [
    # arctic_sf: the forward stages every level, the backward one level a block
    (ARCTIC, 32, torch.float32, 133_760, 100_352),
    (ARCTIC, 32, torch.bfloat16, 66_880, 50_176),
    (SIDE, 32, torch.float32, 160_000, 102_400),
    (SIDE, 32, torch.bfloat16, 80_000, 51_200),
    # a D other than 8, 16, 32: rows that are not whole 16-byte chunks, a
    # lane's channels that are not a vector, or more than a group holds
    (ARCTIC[:2], 71, torch.float32, None, None),
    (ARCTIC, 30, torch.bfloat16, None, None),
    (ARCTIC, 4, torch.float32, None, None),
    (ARCTIC, 24, torch.float32, None, None),
    (ARCTIC, 64, torch.bfloat16, None, None),
    (ARCTIC, 32, torch.float64, None, None),
    # a level too large for shared memory
    (((64, 64),), 32, torch.float32, None, None),
    (((64, 64),), 32, torch.bfloat16, None, None),
    # the limit: 1816 float32 rows of 32, a slab (forward) or a level (backward)
    (((8, 227),), 32, torch.float32, SMEM_LIMIT, SMEM_LIMIT),
    (((8, 228),), 32, torch.float32, None, None),
    (((8, 227), (4, 4)), 32, torch.float32, None, SMEM_LIMIT),
    (((16, 227),), 32, torch.bfloat16, SMEM_LIMIT, SMEM_LIMIT),
    # small heads of the tests' cases
    (((5, 4), (3, 2)), 8, torch.float32, 832, 640),
    (((8, 16), (4, 8)), 16, torch.bfloat16, 5_120, 4_096),
], ids=lambda x: str(x) if not isinstance(x, tuple) else "x".join(map(str, np.ravel(x))))
def test_staged_plan_choices(shapes, D, dtype, fwd, bwd):
    f = staged_plan(shapes, D, dtype)
    b = staged_plan(shapes, D, dtype, backward=True)
    if fwd is None:
        assert f is None
    else:
        assert f == StagedPlan(groups=(tuple(range(len(shapes))),), smem=fwd)
    if bwd is None:
        assert b is None
    else:
        assert b == StagedPlan(groups=tuple((lvl,) for lvl in range(len(shapes))), smem=bwd)


def test_asking_for_a_kernel_the_shapes_do_not_take_raises():
    value = torch.zeros(1, 16, 2, 71)
    loc = torch.zeros(1, 5, 2, 1, 2, 2)
    attn = torch.zeros(1, 5, 2, 1, 2)
    with pytest.raises(ValueError, match="no staged plan"):
        msda_cuda.ms_deform_attn_cuda(value, ((4, 4),), loc, attn, kernel="staged")
    with pytest.raises(ValueError, match="unknown MSDA kernel"):
        msda_cuda.ms_deform_attn_backward_cuda(value, ((4, 4),), loc, attn,
                                               torch.zeros(1, 5, 142), kernel="fast")
    with pytest.raises(ValueError, match="CUDA tensors"):
        msda_cuda.ms_deform_attn_cuda(value, ((4, 4),), loc, attn, kernel="general")


@pytest.mark.parametrize("shapes,D,dtype,fwd,bwd", [
    (ARCTIC, 32, torch.float32, 133_760, 100_352),
    (ARCTIC, 32, torch.bfloat16, 66_880, 50_176),
    # a side of 128 (the TPU row table's height): staged while the slab fits
    (((128, 4), (64, 2)), 32, torch.float32, 81_920, 65_536),
    (((2, 128),), 32, torch.bfloat16, 16_384, 16_384),
    (((128, 16),), 32, torch.float32, None, None),
    (((128, 16),), 32, torch.bfloat16, 131_072, 131_072),
    # WD = 4096, the largest row table: the general kernels
    (((128, 128),), 32, torch.float32, None, None),
    # D = 30 (WD 1792 at arctic_sf's levels): rows of no whole 16-byte chunks
    (ARCTIC, 30, torch.bfloat16, None, None),
    (ARCTIC, 30, torch.float32, None, None),
], ids=lambda x: str(x) if not isinstance(x, tuple) else "x".join(map(str, np.ravel(x))))
def test_staged_plan_for_the_factorized_shapes(shapes, D, dtype, fwd, bwd, monkeypatch):
    """Shapes that `fac_ok` takes get the gather form's plan: the staged
    kernels where it has one, the general ones elsewhere."""
    monkeypatch.setenv("UVHAND_MSDA_FAC", "1")
    assert fac_ok(shapes, D)
    for backward, smem in ((False, fwd), (True, bwd)):
        plan = staged_plan(shapes, D, dtype, backward=backward)
        assert (plan and plan.smem) == smem


@pytest.mark.parametrize("form", ["gather", "fac"])
@pytest.mark.parametrize("kernel,shapes,D,want", [
    ("auto", ARCTIC, 32, "staged"),
    ("auto", ARCTIC, 30, "general"),
    ("auto", ((128, 128),), 32, "general"),
    ("general", ARCTIC, 32, "general"),
    ("staged", ARCTIC, 32, "staged"),
], ids=str)
def test_wrappers_launch_the_kernel_the_plan_picks(form, kernel, shapes, D, want, monkeypatch):
    """Each op's wrapper launches the staged entry with the plan's shared
    memory, or the general entry, and counts the launch by kernel (the
    launch itself replaced: the kernels run only on the card)."""
    ops = {"gather": ("ms_deform_attn_cuda", "ms_deform_attn_backward_cuda", "msda_fwd",
                      "msda_bwd", "FWD", "BWD"),
           "fac": ("ms_deform_attn_fac_cuda", "ms_deform_attn_fac_backward_cuda", "msda_fac_fwd",
                   "msda_fac_bwd", "FAC_FWD", "FAC_BWD")}[form]
    launched = []
    monkeypatch.setattr(msda_cuda, "_launch_forward",
                        lambda entry, what, *args, plan, fac: launched.append((entry, plan)))
    monkeypatch.setattr(msda_cuda, "_launch_backward",
                        lambda entry, what, *args, plan, fac: launched.append((entry, plan)))
    value = torch.zeros(1, sum(h * w for h, w in shapes), 2, D)
    attn = torch.zeros(1, 1, 2, len(shapes), 1)  # in the value's type
    counts = [getattr(msda_cuda, f"{op}_{kind.upper()}") for op in ops[4:]
              for kind in ("staged", "general")]
    wrappers = [getattr(msda_cuda, name) for name in ops[:2]]
    before = [c.launches for c in counts + wrappers]
    getattr(msda_cuda, ops[0])(value, shapes, None, attn, kernel=kernel)
    getattr(msda_cuda, ops[1])(value, shapes, None, attn, None, kernel=kernel)
    suffix = "_staged" if want == "staged" else ""
    assert [entry for entry, _ in launched] == [ops[2] + suffix, ops[3] + suffix]
    for (_, plan), backward in zip(launched, (False, True)):
        assert plan == (staged_plan(shapes, D, torch.float32, backward=backward)
                        if want == "staged" else None)
    delta = [c.launches - n for c, n in zip(counts + wrappers, before)]
    assert delta == ([1, 0, 1, 0] if want == "staged" else [0, 1, 0, 1]) + [1, 1]
