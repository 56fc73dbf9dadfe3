"""The MSDA op on inputs the CUDA kernels do not take as they are, on the CPU.

The kernels take locations in the arithmetic type (float32, float64 for a
float64 value), contiguous value, attention and gradient of the types they
compute (float32, bfloat16, float64; float16 in the factorized form; there
also float32 attention with a bfloat16 or float16 value), and the staged
kernels a 16-byte-aligned value. The op
(`uvhand_tpu_torch/ops/msda.py`) brings the caller's tensors into that form
with `kernel_inputs` before a launch, so that it takes on the card what it
takes on the CPU, as the JAX package's `ms_deform_attn` takes any array.
Here, on CPU tensors:
  - `kernel_inputs` gives that form for a transposed value, an offset
    (unaligned) value, bf16 locations and a non-contiguous attention, and
    hands back tensors already in it as they are;
  - the plain versions (the kernels' arithmetic, bit for bit) on the
    prepared inputs, cast back as the op casts the kernels' results, give
    exactly the plain versions on the caller's tensors: the preparation does
    not change the function, attention of another type included;
  - every pair of value and attention types reaches a kernel that takes
    it (the launch replaced by a stub), with the function unchanged;
  - `ms_deform_attn` and its autograd backward on each such input equal
    those on its contiguous twin, in both forms.
Tolerance: none (bit for bit). The card side of the same calls is
`tests/test_torch_cuda.py` (`test_op_*`).
"""

import numpy as np
import pytest
import torch

from uvhand_tpu_torch.ops.msda import (kernel_inputs, ms_deform_attn, ms_deform_attn_fac_torch,
                                       ms_deform_attn_fac_torch_backward, ms_deform_attn_torch,
                                       ms_deform_attn_torch_backward)

SHAPES = ((6, 5), (3, 3), (2, 2))
B, LQ, M, D, P = 2, 7, 2, 8, 2
#: form: (plain forward, plain backward, UVHAND_MSDA_FAC)
FORMS = {"gather": (ms_deform_attn_torch, ms_deform_attn_torch_backward, "0"),
         "fac": (ms_deform_attn_fac_torch, ms_deform_attn_fac_torch_backward, "1")}


def inputs(dtype, seed=0, lo=-0.2, hi=1.2):
    rng = np.random.default_rng(seed)
    S, L = sum(h * w for h, w in SHAPES), len(SHAPES)
    value = torch.from_numpy(rng.standard_normal((B, S, M, D)).astype(np.float32)).to(dtype)
    loc = torch.from_numpy(rng.uniform(lo, hi, (B, LQ, M, L, P, 2)).astype(np.float32))
    logits = rng.standard_normal((B, LQ, M, L * P))
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    attn = torch.from_numpy(attn.reshape(B, LQ, M, L, P).astype(np.float32)).to(dtype)
    grad = torch.from_numpy(rng.standard_normal((B, LQ, M * D)).astype(np.float32)).to(dtype)
    return value, loc, attn, grad


def offset(t):
    """`t`'s values in a tensor whose data starts one element past an
    allocation: contiguous, not 16-byte aligned."""
    return torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape).copy_(t)


#: the caller's tensors the kernels do not take as they are, on any device;
#: each keeps the values
UNPREPARED = {
    "transposed_value": lambda v, loc, a: (v.transpose(2, 3).contiguous().transpose(2, 3),
                                           loc, a),
    "offset_value": lambda v, loc, a: (offset(v), loc, a),
    "bf16_locations": lambda v, loc, a: (v, loc.bfloat16(), a),
    "strided_attention": lambda v, loc, a: (v, loc, torch.cat([a, a], -1)[..., : a.shape[-1]]),
}
DTYPES = [torch.float32, torch.bfloat16]


def raw_inputs(name, dtype):
    value, loc, attn, grad = inputs(dtype)
    if name == "bf16_locations":  # values a bf16 tensor holds, so the twin is exact
        loc = loc.bfloat16().float()
    return (*UNPREPARED[name](value, loc, attn), grad), (value, loc, attn, grad)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", sorted(UNPREPARED))
def test_kernel_inputs_give_the_kernels_form(name, dtype, form):
    (value, loc, attn, grad), _ = raw_inputs(name, dtype)
    grad = torch.cat([grad, grad], -1)[..., : M * D]  # an incoming gradient with strides
    got = kernel_inputs(value, loc, attn, form == "fac", grad)
    v, lc, a, g = got
    assert all(t.is_contiguous() for t in got)
    assert v.data_ptr() % 16 == 0
    assert lc.dtype == torch.float32 and v.dtype == a.dtype == g.dtype == dtype
    assert [t.shape for t in got] == [value.shape, loc.shape, attn.shape, grad.shape]
    for prepared, caller in zip(got, (value, loc, attn, grad)):
        assert torch.equal(prepared, caller.to(prepared.dtype))
    if name == "offset_value":
        assert value.data_ptr() % 16 and value.is_contiguous()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_inputs_hand_back_tensors_already_in_form(dtype):
    """The model paths' inputs are already in the kernels' form: no copy."""
    value, loc, attn, grad = inputs(dtype)
    for fac in (False, True):
        got = kernel_inputs(value, loc, attn, fac, grad)
        assert all(p is c for p, c in zip(got, (value, loc, attn, grad)))


def run_as_on_the_card(form, value, loc, attn, grad):
    """What the op does on the card, with the plain versions in place of the
    kernels (they repeat the kernels' arithmetic): prepare, run, cast back."""
    fwd, bwd, _ = FORMS[form]
    v, lc, a, g = kernel_inputs(value, loc, attn, form == "fac", grad)
    out = fwd(v, SHAPES, lc, a).to(value.dtype)
    dv, dl, da = bwd(v, SHAPES, lc, a, g)
    return out, dv.to(value.dtype), dl.to(loc.dtype), da.to(attn.dtype)


def assert_same(got, want):
    for name, g, w in zip(("out", "dvalue", "dloc", "dattn"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), (name, (g.float() - w.float()).abs().max().item())


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", sorted(UNPREPARED))
def test_kernel_inputs_keep_the_function(name, dtype, form):
    (value, loc, attn, grad), _ = raw_inputs(name, dtype)
    fwd, bwd, _ = FORMS[form]
    assert_same(run_as_on_the_card(form, value, loc, attn, grad),
                (fwd(value, SHAPES, loc, attn), *bwd(value, SHAPES, loc, attn, grad)))


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("vdt,adt", [(torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float32, torch.float64)], ids=str)
def test_kernel_inputs_take_attention_of_another_type(vdt, adt, form):
    """The plain versions compute the attention in float32 (or the value's
    wider type): a float32 value takes any attention type, made float32; a
    bfloat16 value takes one in the gather form, which computes in float32
    anyway (value widened, results rounded back), and in the factorized
    form, which rounds at the value's type, keeps its type and gets the
    attention in float32, which the factorized general kernels read."""
    value, loc, attn, grad = inputs(vdt)
    attn = attn.to(adt)
    v, lc, a, g = kernel_inputs(value, loc, attn, form == "fac", grad)
    if form == "fac" and vdt == torch.bfloat16:
        assert v.dtype == g.dtype == torch.bfloat16 and a.dtype == torch.float32
    else:
        assert v.dtype == a.dtype == g.dtype == torch.float32
    fwd, bwd, _ = FORMS[form]
    assert_same(run_as_on_the_card(form, value, loc, attn, grad),
                (fwd(value, SHAPES, loc, attn), *bwd(value, SHAPES, loc, attn, grad)))


def test_kernel_inputs_leave_other_value_types_to_the_wrapper():
    """A float64 value keeps its type (the general kernels of both forms
    compute in float64, on float64 locations); a float16 value keeps it in
    the factorized form (its general kernels round at float16) and is
    widened to float32 in the gather form, which computes in float32."""
    value, loc, attn, grad = inputs(torch.float32)
    for fac in (False, True):
        v, lc, a, g = kernel_inputs(value.double(), loc, attn, fac, grad.double())
        assert v.dtype == a.dtype == g.dtype == lc.dtype == torch.float64
        v, lc, a, g = kernel_inputs(value.half(), loc, attn.half(), fac, grad.half())
        assert v.dtype == a.dtype == g.dtype == (torch.float16 if fac else torch.float32)
        assert lc.dtype == torch.float32


ALL_TYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("adt", ALL_TYPES, ids=str)
@pytest.mark.parametrize("vdt", ALL_TYPES, ids=str)
def test_every_value_and_attention_type_reaches_a_kernel(vdt, adt, form, monkeypatch):
    """Every pair of value and attention types the CPU path takes: the
    prepared inputs pass the wrappers' type checks, the wrapper launches the
    staged kernel only for float32 or bfloat16 value and attention of one
    type (the model paths') and the general one otherwise (launch replaced
    by a stub: the kernels run only on the card), and the plain versions on
    the prepared inputs, cast back, equal them on the caller's, bit for
    bit."""
    from uvhand_tpu_torch.ops import msda_cuda
    fac = form == "fac"
    value, loc, attn, grad = inputs(vdt, seed=1)
    attn = attn.to(adt)
    v, lc, a, g = kernel_inputs(value, loc, attn, fac, grad)
    msda_cuda.check_types(("value", v), lc, a, [("grad_out", g)],
                          msda_cuda.FAC_TYPES if fac else msda_cuda.GATHER_TYPES, mixed=fac)
    launched = []
    for name in ("_launch_forward", "_launch_backward"):
        monkeypatch.setattr(msda_cuda, name,
                            lambda entry, what, *args, plan, fac: launched.append(entry))
    prefix = "msda_fac_" if fac else "msda_"
    wrappers = ((msda_cuda.ms_deform_attn_fac_cuda, msda_cuda.ms_deform_attn_fac_backward_cuda)
                if fac else (msda_cuda.ms_deform_attn_cuda,
                             msda_cuda.ms_deform_attn_backward_cuda))
    # D = 8 rows fit a staged plan at these shapes
    wrappers[0](v, SHAPES, lc, a)
    wrappers[1](v, SHAPES, lc, a, g)
    staged = v.dtype == a.dtype and v.dtype in (torch.float32, torch.bfloat16)
    suffix = "_staged" if staged else ""
    assert launched == [prefix + "fwd" + suffix, prefix + "bwd" + suffix]
    if v.dtype == torch.bfloat16 and a.dtype == torch.bfloat16:
        assert vdt == adt == torch.bfloat16  # only the model paths' own bf16 stays bf16
    fwd, bwd, _ = FORMS[form]
    assert_same(run_as_on_the_card(form, value, loc, attn, grad),
                (fwd(value, SHAPES, loc, attn), *bwd(value, SHAPES, loc, attn, grad)))


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", sorted(UNPREPARED))
def test_op_on_an_unprepared_input_equals_its_contiguous_twin(name, dtype, form, monkeypatch):
    monkeypatch.setenv("UVHAND_MSDA_FAC", FORMS[form][2])
    (value, loc, attn, grad), twin = raw_inputs(name, dtype)
    results = []
    for args in ((value, loc, attn), twin[:3]):
        leaves = [t.detach().requires_grad_() for t in args]  # the same storage and strides
        out = ms_deform_attn(leaves[0], SHAPES, leaves[1], leaves[2])
        out.backward(grad)
        results.append((out.detach(), *(t.grad for t in leaves)))
    got, want = results
    # the twin's locations are float32: its dloc rounded to bf16 is the raw's
    assert_same(got, (want[0], want[1], want[2].to(got[2].dtype), want[3]))
