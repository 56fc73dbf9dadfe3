"""The CUDA MSDA kernels -- the gather form (`msda_fwd.cu`, `msda_bwd.cu`)
and the factorized form (`msda_fac_fwd.cu`, `msda_fac_bwd.cu`), each a
staged and a general kernel -- against their plain versions, on the card.

The kernels have no CPU mode, so these tests are marked `cuda` and skip where
no card is present. On a machine with one (which need not have JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: forward 1e-5 relative to max|value| in float32 (the kernel is
built without fused multiply-add and matches bit for bit in practice) and
2e-2 in bfloat16. Backward 1e-5 relative to each gradient's max in float32
(dvalue is summed by atomics in no fixed order) and 2e-2 in bfloat16. The
two formulations against each other on the same inputs: the same tolerances
(in bfloat16 they round at different places). The staged gather kernels
against the general ones: the forward and the backward's dloc and dattn
bit-identical (both repeat the plain version's order), dvalue within the
backward's tolerance. Each factorized kernel, staged and general: the
forward and the backward's dloc and dattn bit-identical to the plain
versions, dvalue within the backward's tolerance. `ms_deform_attn` on inputs
the kernels do not take as they are (a misaligned or transposed value,
bfloat16 locations, attention of another type) equals the plain version on
the same inputs; so does it on a float16 or float64 value, both forms
(float16 2e-3 and float64 1e-12 of dvalue's max: its sums are float32 or
float64 atomics, and float16 rounds them once).

The research kernels (`uvhand_tpu_torch/ops/msda_ablation.py`,
`uvhand_tpu_torch/ops/probes.py`), in float32 and bfloat16: the ablation
backward's dpy, dpx and daw and every output of `msda_xdot` bit-identical to
their plain versions, the ablation's dvalue (atomics) and `msda_onlyg`'s
dvalue (another summation order) within 1e-5 of their max, `msda_onlyg`'s
daw bit-identical; the probes exact.
"""

import pytest
import torch

from uvhand_tpu_torch.ops import msda_ablation, msda_cuda, probes
from uvhand_tpu_torch.ops.msda import (ms_deform_attn, ms_deform_attn_fac_torch,
                                       ms_deform_attn_fac_torch_backward, ms_deform_attn_torch,
                                       ms_deform_attn_torch_backward)

from test_torch_msda_inputs import UNPREPARED  # inputs the kernels do not take as they are

CASES = {
    # name: (b, lq, m, d, p, shapes, loc range)
    "encoder": (2, 1045, 8, 32, 4, ((28, 28), (14, 14), (7, 7), (4, 4)), (0.0, 1.0)),
    "decoder": (2, 300, 8, 32, 4, ((28, 28), (14, 14), (7, 7), (4, 4)), (-1.0, 1.0)),
    "out_of_range": (2, 64, 2, 8, 3, ((5, 4), (3, 2)), (-2.0, 3.0)),
    "odd_d": (1, 50, 2, 71, 2, ((6, 4), (3, 2)), (-0.2, 1.2)),
    "side_over_128": (1, 90, 2, 8, 2, ((2, 130), (150, 3)), (-0.1, 1.1)),
    "side_of_one": (2, 70, 2, 8, 2, ((6, 5), (2, 1), (1, 1)), (0.0, 1.0)),
    # every sample on an exact pixel centre: the tents' kinks
    "integer_exact": (2, 40, 2, 16, 2, ((8, 16), (4, 8)), "integer"),
}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3, torch.float64: 1e-12}
#: formulation: (forward kernel, its plain version, backward kernel, its plain version)
FORMS = {
    "gather": (msda_cuda.ms_deform_attn_cuda, ms_deform_attn_torch,
               msda_cuda.ms_deform_attn_backward_cuda, ms_deform_attn_torch_backward),
    "fac": (msda_cuda.ms_deform_attn_fac_cuda, ms_deform_attn_fac_torch,
            msda_cuda.ms_deform_attn_fac_backward_cuda, ms_deform_attn_fac_torch_backward),
}


def make_inputs(case, dtype, device):
    b, lq, m, d, p, shapes, rng_ = CASES[case]
    gen = torch.Generator(device=device).manual_seed(0)
    S, L = sum(h * w for h, w in shapes), len(shapes)
    value = torch.randn(b, S, m, d, generator=gen, device=device).to(dtype)
    if rng_ == "integer":
        # (cell + 0.5) / size with power-of-two sizes is exact in float32
        size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=device)
        cells = torch.floor(torch.rand(b, lq, m, L, p, 2, generator=gen, device=device)
                            * size[:, None, :])
        loc = (cells + 0.5) / size[:, None, :]
    else:
        lo, hi = rng_
        loc = lo + (hi - lo) * torch.rand(b, lq, m, L, p, 2, generator=gen, device=device)
    attn = torch.randn(b, lq, m, L * p, generator=gen, device=device).softmax(-1)
    return value, shapes, loc, attn.view(b, lq, m, L, p).to(dtype), gen


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case, dtype, form):
    value, shapes, loc, attn, _ = make_inputs(case, dtype, cuda)
    b, lq, m, d = CASES[case][:4]
    kernel, plain = FORMS[form][:2]
    before = kernel.launches
    out = kernel(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = plain(value, shapes, loc, attn)
    assert out.dtype == dtype and out.shape == (b, lq, m * d)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * value.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_kernel_matches_plain(cuda, case, dtype, form):
    value, shapes, loc, attn, gen = make_inputs(case, dtype, cuda)
    b, lq, m, d = CASES[case][:4]
    grad = torch.randn(b, lq, m * d, generator=gen, device=cuda).to(dtype)
    kernel, plain = FORMS[form][2:]
    before = kernel.launches
    ours = kernel(value, shapes, loc, attn, grad)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = plain(value, shapes, loc, attn, grad)
    for name, o, r, want in zip(("dvalue", "dloc", "dattn"), ours, ref,
                                (dtype, torch.float32, dtype)):
        assert o.dtype == want and o.shape == r.shape, name
        assert torch.isfinite(o.float()).all(), name
        err = (o.float() - r.float()).abs().max().item()
        assert err <= TOL[dtype] * max(r.float().abs().max().item(), 1e-12), (name, err)


STAGED_CASES = ["encoder", "decoder", "out_of_range", "side_over_128", "side_of_one",
                 "integer_exact"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", STAGED_CASES)
def test_staged_kernels_match_general_and_plain(cuda, case, dtype):
    value, shapes, loc, attn, gen = make_inputs(case, dtype, cuda)
    b, lq, m, d = CASES[case][:4]
    grad = torch.randn(b, lq, m * d, generator=gen, device=cuda).to(dtype)
    assert msda_cuda.staged_plan(shapes, d, dtype) is not None
    assert msda_cuda.staged_plan(shapes, d, dtype, backward=True) is not None
    fwd, bwd = msda_cuda.ms_deform_attn_cuda, msda_cuda.ms_deform_attn_backward_cuda
    out = fwd(value, shapes, loc, attn, kernel="staged")
    general = fwd(value, shapes, loc, attn, kernel="general")
    grads = bwd(value, shapes, loc, attn, grad, kernel="staged")
    general_grads = bwd(value, shapes, loc, attn, grad, kernel="general")
    torch.cuda.synchronize()
    assert torch.equal(out, general)
    if dtype == torch.float32:
        assert torch.equal(out, ms_deform_attn_torch(value, shapes, loc, attn))
    ref = ms_deform_attn_torch_backward(value, shapes, loc, attn, grad)
    for name, o, g, r in zip(("dvalue", "dloc", "dattn"), grads, general_grads, ref):
        assert_matches(name, o, r, TOL[dtype])
        assert_matches(name, o, g, TOL[dtype] if name == "dvalue" else 0.0)


#: (case, dtype, kind) of each factorized kernel: the staged one where the
#: shapes have a plan (both directions share it), the general one on every case
FAC_KINDS = [(case, dtype, kind) for case in sorted(CASES)
             for dtype in (torch.float32, torch.bfloat16)
             for kind in ("staged", "general")
             if kind == "general" or msda_cuda.staged_plan(CASES[case][5], CASES[case][3], dtype)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype,kind", FAC_KINDS, ids=str)
def test_fac_kernels_match_plain_exactly(cuda, case, dtype, kind):
    value, shapes, loc, attn, gen = make_inputs(case, dtype, cuda)
    b, lq, m, d = CASES[case][:4]
    grad = torch.randn(b, lq, m * d, generator=gen, device=cuda).to(dtype)
    fwd, bwd = msda_cuda.ms_deform_attn_fac_cuda, msda_cuda.ms_deform_attn_fac_backward_cuda
    counts = {"staged": (msda_cuda.FAC_FWD_STAGED, msda_cuda.FAC_BWD_STAGED),
              "general": (msda_cuda.FAC_FWD_GENERAL, msda_cuda.FAC_BWD_GENERAL)}[kind]
    before = [c.launches for c in counts]
    out = fwd(value, shapes, loc, attn, kernel=kind)
    grads = bwd(value, shapes, loc, attn, grad, kernel=kind)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counts, before)] == [1, 1]
    assert_matches("forward", out, ms_deform_attn_fac_torch(value, shapes, loc, attn), 0.0)
    ref = ms_deform_attn_fac_torch_backward(value, shapes, loc, attn, grad)
    for name, o, r in zip(("dvalue", "dloc", "dattn"), grads, ref):
        assert_matches(name, o, r, TOL[dtype] if name == "dvalue" else 0.0)


def exact_tol(form, dtype):
    """The tolerance of a forward, dloc or dattn against the plain version:
    none where the kernels are known to repeat its order bit for bit (the
    factorized kernels; the gather kernels in float32), else TOL."""
    return 0.0 if form == "fac" or dtype == torch.float32 else TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("unprepared", sorted(UNPREPARED))
def test_op_takes_inputs_the_kernels_do_not_take_as_they_are(cuda, unprepared, dtype, form,
                                                             monkeypatch):
    monkeypatch.setenv("UVHAND_MSDA_FAC", "1" if form == "fac" else "0")
    value, shapes, loc, attn, _ = make_inputs("decoder", dtype, cuda)
    value, loc, attn = UNPREPARED[unprepared](value, loc, attn)
    if unprepared == "offset_value":
        assert value.data_ptr() % 16
    else:
        assert value.data_ptr() % 16 == 0
    plain = FORMS[form][1]
    got = ms_deform_attn(value, shapes, loc, attn)
    torch.cuda.synchronize()
    want = plain(value, shapes, loc, attn)
    assert_matches("forward", got, want, exact_tol(form, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("unprepared", sorted(UNPREPARED))
def test_op_backward_takes_inputs_the_kernels_do_not_take_as_they_are(cuda, unprepared, dtype,
                                                                      form, monkeypatch):
    monkeypatch.setenv("UVHAND_MSDA_FAC", "1" if form == "fac" else "0")
    value, shapes, loc, attn, gen = make_inputs("decoder", dtype, cuda)
    b, lq, m, d = CASES["decoder"][:4]
    grad = torch.randn(b, lq, m * d, generator=gen, device=cuda).to(dtype)
    value, loc, attn = UNPREPARED[unprepared](value, loc, attn)
    leaves = [t.detach().requires_grad_() for t in (value, loc, attn)]
    ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2]).backward(grad)
    torch.cuda.synchronize()
    ref = FORMS[form][3](value, shapes, loc, attn, grad)
    for name, leaf, r in zip(("dvalue", "dloc", "dattn"), leaves, ref):
        assert leaf.grad.shape == leaf.shape and leaf.grad.dtype == leaf.dtype, name
        assert_matches(name, leaf.grad, r, TOL[dtype] if name == "dvalue" else
                       exact_tol(form, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("vdt,adt", [(torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float16, torch.float32)], ids=str)
def test_op_takes_attention_of_another_type(cuda, vdt, adt, form, monkeypatch):
    """Attention of another type than the value's: taken as the CPU path
    takes it. With a bfloat16 or float16 value the factorized form keeps
    the value's type (it rounds at it) and its general kernels read the
    attention in float32; the gather form computes in float32."""
    monkeypatch.setenv("UVHAND_MSDA_FAC", "1" if form == "fac" else "0")
    value, shapes, loc, attn, gen = make_inputs("decoder", vdt, cuda)
    attn = attn.to(adt)
    b, lq, m, d = CASES["decoder"][:4]
    grad = torch.randn(b, lq, m * d, generator=gen, device=cuda).to(vdt)
    leaves = [t.detach().requires_grad_() for t in (value, loc, attn)]
    out = ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
    out.backward(grad)
    torch.cuda.synchronize()
    assert_matches("forward", out.detach(), FORMS[form][1](value, shapes, loc, attn),
                   exact_tol(form, vdt))
    ref = FORMS[form][3](value, shapes, loc, attn, grad)
    for name, leaf, r in zip(("dvalue", "dloc", "dattn"), leaves, ref):
        assert_matches(name, leaf.grad, r, TOL[vdt] if name == "dvalue" else
                       exact_tol(form, vdt))


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64], ids=str)
@pytest.mark.parametrize("case", ["decoder", "out_of_range", "integer_exact"])
def test_op_takes_float16_and_float64_values(cuda, case, dtype, form, monkeypatch):
    """A float16 or float64 value (attention in its type, locations in the
    arithmetic type): the gather form widens float16 to float32 (the plain
    version computes it so) and runs float64 in the general kernel in
    float64; the factorized form's general kernels round at float16 and
    compute float64 throughout. Forward, dloc and dattn equal the plain
    version bit for bit; dvalue (atomics) within TOL."""
    monkeypatch.setenv("UVHAND_MSDA_FAC", "1" if form == "fac" else "0")
    value, shapes, loc, attn, gen = make_inputs(case, dtype, cuda)
    loc = loc.to(torch.promote_types(dtype, torch.float32))
    b, lq, m, d = CASES[case][:4]
    grad = torch.randn(b, lq, m * d, generator=gen, device=cuda).to(dtype)
    leaves = [t.detach().requires_grad_() for t in (value, loc, attn)]
    general = [msda_cuda.FAC_FWD_GENERAL, msda_cuda.FAC_BWD_GENERAL, msda_cuda.FWD_GENERAL,
               msda_cuda.BWD_GENERAL]
    before = [c.launches for c in general]
    out = ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
    out.backward(grad)
    torch.cuda.synchronize()
    assert_matches("forward", out.detach(), FORMS[form][1](value, shapes, loc, attn), 0.0)
    ref = FORMS[form][3](value, shapes, loc, attn, grad)
    for name, leaf, r in zip(("dvalue", "dloc", "dattn"), leaves, ref):
        assert leaf.grad.dtype == leaf.dtype, name
        assert_matches(name, leaf.grad, r, TOL[dtype] if name == "dvalue" else 0.0)
    delta = [c.launches - n for c, n in zip(general, before)]
    # float16 in the gather form runs the float32 kernels (staged where planned)
    want = [1, 1, 0, 0] if form == "fac" else [0, 0, 1, 1] if dtype == torch.float64 else None
    if want is not None:
        assert delta == want


@pytest.mark.cuda
@pytest.mark.parametrize("case,kind", [("encoder", "staged"), ("odd_d", "general"),
                                       ("integer_exact", "staged")])
def test_each_kernel_counts_its_launches(cuda, case, kind):
    value, shapes, loc, attn, gen = make_inputs(case, torch.float32, cuda)
    b, lq, m, d = CASES[case][:4]
    grad = torch.randn(b, lq, m * d, generator=gen, device=cuda)
    counts = {"fwd": msda_cuda.ms_deform_attn_cuda, "bwd": msda_cuda.ms_deform_attn_backward_cuda,
              "ablate": msda_cuda.ms_deform_attn_ablate_backward_cuda,
              "fac_fwd": msda_cuda.ms_deform_attn_fac_cuda,
              "fac_bwd": msda_cuda.ms_deform_attn_fac_backward_cuda,
              "fwd_staged": msda_cuda.FWD_STAGED, "fwd_general": msda_cuda.FWD_GENERAL,
              "bwd_staged": msda_cuda.BWD_STAGED, "bwd_general": msda_cuda.BWD_GENERAL,
              "ablate_staged": msda_cuda.ABLATE_STAGED,
              "ablate_general": msda_cuda.ABLATE_GENERAL,
              "fac_fwd_staged": msda_cuda.FAC_FWD_STAGED,
              "fac_fwd_general": msda_cuda.FAC_FWD_GENERAL,
              "fac_bwd_staged": msda_cuda.FAC_BWD_STAGED,
              "fac_bwd_general": msda_cuda.FAC_BWD_GENERAL}
    before = {n: c.launches for n, c in counts.items()}
    msda_cuda.ms_deform_attn_cuda(value, shapes, loc, attn)
    msda_cuda.ms_deform_attn_backward_cuda(value, shapes, loc, attn, grad)
    msda_cuda.ms_deform_attn_ablate_backward_cuda(value, shapes, loc, attn, grad)
    msda_cuda.ms_deform_attn_fac_cuda(value, shapes, loc, attn)
    msda_cuda.ms_deform_attn_fac_backward_cuda(value, shapes, loc, attn, grad)
    torch.cuda.synchronize()
    delta = {n: c.launches - before[n] for n, c in counts.items()}
    other = "general" if kind == "staged" else "staged"
    ops = ("fwd", "bwd", "ablate", "fac_fwd", "fac_bwd")
    assert delta == {**{op: 1 for op in ops}, **{f"{op}_{kind}": 1 for op in ops},
                     **{f"{op}_{other}": 0 for op in ops}}


@pytest.mark.cuda
@pytest.mark.parametrize("shapes,backward", [(((8, 227),), False), (((8, 227),), True)])
def test_staged_kernels_at_the_shared_memory_limit(cuda, shapes, backward):
    """A slab of exactly SMEM_LIMIT bytes launches staged; one row more does
    not have a plan, and asking for the staged kernel then raises."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    S = shapes[0][0] * shapes[0][1]
    value = torch.randn(1, S, 2, 32, generator=gen, device=cuda)
    loc = torch.rand(1, 50, 2, 1, 4, 2, generator=gen, device=cuda) * 1.2 - 0.1
    attn = torch.rand(1, 50, 2, 1, 4, generator=gen, device=cuda)
    grad = torch.randn(1, 50, 64, generator=gen, device=cuda)
    plan = msda_cuda.staged_plan(shapes, 32, torch.float32, backward=backward)
    assert plan.smem == msda_cuda.SMEM_LIMIT
    if backward:
        got = msda_cuda.ms_deform_attn_backward_cuda(value, shapes, loc, attn, grad,
                                                     kernel="staged")
        for name, g, r in zip(("dvalue", "dloc", "dattn"), got,
                              ms_deform_attn_torch_backward(value, shapes, loc, attn, grad)):
            assert_matches(name, g, r, TOL[torch.float32])
    else:
        got = msda_cuda.ms_deform_attn_cuda(value, shapes, loc, attn, kernel="staged")
        assert torch.equal(got, ms_deform_attn_torch(value, shapes, loc, attn))
    wider = ((shapes[0][0], shapes[0][1] + 1),)
    assert msda_cuda.staged_plan(wider, 32, torch.float32, backward=backward) is None
    S = wider[0][0] * wider[0][1]
    value = torch.randn(1, S, 2, 32, generator=gen, device=cuda)
    with pytest.raises(ValueError, match="no staged plan"):
        if backward:
            msda_cuda.ms_deform_attn_backward_cuda(value, wider, loc, attn, grad, kernel="staged")
        else:
            msda_cuda.ms_deform_attn_cuda(value, wider, loc, attn, kernel="staged")


@pytest.mark.cuda
def test_staged_kernels_refuse_a_misaligned_value(cuda):
    shapes = ((4, 4),)
    value = torch.randn(16 * 2 * 8 + 1, device=cuda)[1:].view(1, 16, 2, 8)
    loc = torch.rand(1, 5, 2, 1, 2, 2, device=cuda)
    attn = torch.rand(1, 5, 2, 1, 2, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        msda_cuda.ms_deform_attn_cuda(value, shapes, loc, attn)
    with pytest.raises(ValueError, match="16-byte aligned"):
        msda_cuda.ms_deform_attn_backward_cuda(value, shapes, loc, attn,
                                               torch.randn(1, 5, 16, device=cuda))
    general = msda_cuda.ms_deform_attn_cuda(value, shapes, loc, attn, kernel="general")
    assert torch.equal(general, ms_deform_attn_torch(value, shapes, loc, attn))


@pytest.mark.cuda
def test_autograd_goes_through_both_kernels(cuda):
    value, shapes, loc, attn, _ = make_inputs("decoder", torch.float32, cuda)
    fwd, bwd = msda_cuda.ms_deform_attn_cuda.launches, msda_cuda.ms_deform_attn_backward_cuda.launches
    leaves = [t.clone().requires_grad_() for t in (value, loc, attn)]
    ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2]).square().sum().backward()
    assert msda_cuda.ms_deform_attn_cuda.launches == fwd + 1
    assert msda_cuda.ms_deform_attn_backward_cuda.launches == bwd + 1
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)


@pytest.mark.cuda
def test_autograd_goes_through_both_fac_kernels(cuda, monkeypatch):
    monkeypatch.setenv("UVHAND_MSDA_FAC", "1")
    value, shapes, loc, attn, _ = make_inputs("decoder", torch.bfloat16, cuda)
    counters = (msda_cuda.ms_deform_attn_fac_cuda, msda_cuda.ms_deform_attn_fac_backward_cuda,
                msda_cuda.ms_deform_attn_cuda, msda_cuda.ms_deform_attn_backward_cuda)
    before = [c.launches for c in counters]
    leaves = [t.clone().requires_grad_() for t in (value, loc, attn)]
    ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2]).float().square().sum().backward()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 0, 0]
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all() for t in leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", ["encoder", "decoder", "odd_d", "side_of_one", "integer_exact"])
def test_fac_kernels_agree_with_gather_kernels(cuda, case, dtype):
    """Two formulations of one function: forward and every gradient agree
    on the same inputs."""
    value, shapes, loc, attn, gen = make_inputs(case, dtype, cuda)
    b, lq, m, d = CASES[case][:4]
    grad = torch.randn(b, lq, m * d, generator=gen, device=cuda).to(dtype)
    fwd, _, bwd, _ = FORMS["gather"]
    fac_fwd, _, fac_bwd, _ = FORMS["fac"]
    pairs = [("forward", fac_fwd(value, shapes, loc, attn), fwd(value, shapes, loc, attn))]
    pairs += list(zip(("dvalue", "dloc", "dattn"), fac_bwd(value, shapes, loc, attn, grad),
                      bwd(value, shapes, loc, attn, grad)))
    for name, f, g in pairs:
        err = (f.float() - g.float()).abs().max().item()
        assert err <= TOL[dtype] * max(g.float().abs().max().item(), 1e-12), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda, form):
    shapes = ((4, 4),)
    value = torch.randn(1, 16, 2, 8, device=cuda)
    loc = torch.rand(1, 5, 2, 1, 2, 2, device=cuda)
    attn = torch.rand(1, 5, 2, 1, 2, device=cuda)
    fwd = FORMS[form][0]
    with pytest.raises(TypeError):
        fwd(value.double(), shapes, loc, attn.double())
    with pytest.raises(ValueError, match="contiguous"):
        fwd(value.transpose(2, 3), shapes, loc, attn)
    with pytest.raises(ValueError, match="spatial_shapes"):
        fwd(value, ((4, 5),), loc, attn)


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
def test_backward_wrapper_rejects_what_the_kernel_does_not_take(cuda, form):
    shapes = ((4, 4),)
    value = torch.randn(1, 16, 2, 8, device=cuda)
    loc = torch.rand(1, 5, 2, 1, 2, 2, device=cuda)
    attn = torch.rand(1, 5, 2, 1, 2, device=cuda)
    grad = torch.randn(1, 5, 16, device=cuda)
    bwd = FORMS[form][2]
    with pytest.raises(TypeError):
        bwd(value.double(), shapes, loc, attn.double(), grad.double())
    with pytest.raises(TypeError, match="grad_out dtype"):
        bwd(value, shapes, loc, attn, grad.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        bwd(value, shapes, loc, attn, grad.view(1, 16, 5).transpose(1, 2))
    with pytest.raises(ValueError, match="spatial_shapes"):
        bwd(value, ((4, 5),), loc, attn, grad)
    with pytest.raises(ValueError, match="grad_out must be"):
        bwd(value, shapes, loc, attn, grad[:, :4].contiguous())
    with pytest.raises(ValueError, match="CUDA tensors"):
        bwd(value.cpu(), shapes, loc.cpu(), attn.cpu(), grad.cpu())


ABLATION_CASES = ["decoder", "odd_d", "side_over_128", "integer_exact"]


def ablation_inputs(case, dtype, device):
    value, shapes, loc, attn, gen = make_inputs(case, dtype, device)
    b, lq, m, d = CASES[case][:4]
    grad = torch.randn(b, lq, m * d, generator=gen, device=device).to(dtype)
    return value, shapes, loc, attn, grad


def assert_matches(name, got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert torch.isfinite(got.float()).all(), name
    if tol == 0.0:
        assert torch.equal(got, want), (name, (got.float() - want.float()).abs().max().item())
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * max(want.float().abs().max().item(), 1e-12), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("gate", msda_ablation.GATES)
@pytest.mark.parametrize("out", msda_ablation.OUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", ABLATION_CASES)
def test_ablation_kernel_matches_plain(cuda, case, dtype, out, gate):
    args = ablation_inputs(case, dtype, cuda)
    kernel = msda_cuda.ms_deform_attn_ablate_backward_cuda
    before = kernel.launches
    got = kernel(*args, out=out, gate=gate)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = msda_ablation.ablate_backward_torch(*args, out=out, gate=gate)
    for name, g, w in zip(("dv", "dpy", "dpx", "daw"), got, want):
        assert_matches(name, g, w, 1e-5 if name == "dv" else 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", ["decoder", "odd_d", "side_over_128"])
def test_onlyg_kernel_matches_plain(cuda, case, dtype):
    args = ablation_inputs(case, dtype, cuda)
    kernel = msda_cuda.ms_deform_attn_onlyg_cuda
    before = kernel.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = msda_ablation.onlyg_torch(*args)
    for name, g, w in zip(("dv", "dpy", "dpx", "daw"), got, want):
        assert_matches(name, g, w, 1e-5 if name == "dv" else 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", ABLATION_CASES)
def test_xdot_kernel_matches_plain(cuda, case, dtype):
    value, shapes, loc, attn, grad = ablation_inputs(case, dtype, cuda)
    G = msda_ablation.dense_plane(value, grad)
    kernel = msda_cuda.ms_deform_attn_xdot_cuda
    before = kernel.launches
    got = kernel(G, shapes, loc, attn)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = msda_ablation.xdot_torch(G, shapes, loc, attn)
    for name, g, w in zip(("dpy", "dpx", "daw", "ws"), got, want):
        assert_matches(name, g, w, 0.0)


@pytest.mark.cuda
def test_lane_slice_kernel_matches_plain(cuda):
    x = torch.randn(1048, 128, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    before = msda_cuda.lane_slice_cuda.launches
    got = msda_cuda.lane_slice_cuda(x, 8, 16)
    torch.cuda.synchronize()
    assert msda_cuda.lane_slice_cuda.launches == before + 1
    assert torch.equal(got, probes.lane_slice_torch(x, 8, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis", [((1408, 128), 0), ((1408, 128), 1), ((1408, 128), -1),
                                        ((8, 1048, 128), 2), ((3, 40, 1408), 1),
                                        ((128, 8, 128), -2)])
def test_gather_kernel_matches_plain(cuda, shape, axis):
    gen = torch.Generator(device=cuda).manual_seed(0)
    v = torch.randn(shape, generator=gen, device=cuda)
    idx = torch.randint(0, shape[axis], shape, generator=gen, device=cuda, dtype=torch.int32)
    before = msda_cuda.take_along_axis_cuda.launches
    got = msda_cuda.take_along_axis_cuda(v, idx, axis)
    torch.cuda.synchronize()
    assert msda_cuda.take_along_axis_cuda.launches == before + 1
    assert torch.equal(got, probes.take_along_axis_torch(v, idx, axis))
    idx.view(-1)[0] = shape[axis]  # out of range: NaN, never a read outside v
    assert torch.isnan(msda_cuda.take_along_axis_cuda(v, idx, axis).view(-1)[0])


@pytest.mark.cuda
def test_research_wrappers_reject_what_the_kernels_do_not_take(cuda):
    shapes = ((4, 4),)
    value = torch.randn(1, 16, 2, 8, device=cuda)
    loc = torch.rand(1, 5, 2, 1, 2, 2, device=cuda)
    attn = torch.rand(1, 5, 2, 1, 2, device=cuda)
    grad = torch.randn(1, 5, 16, device=cuda)
    ablate = msda_cuda.ms_deform_attn_ablate_backward_cuda
    onlyg = msda_cuda.ms_deform_attn_onlyg_cuda
    xdot = msda_cuda.ms_deform_attn_xdot_cuda
    for fn in (ablate, onlyg):
        with pytest.raises(TypeError):
            fn(value.double(), shapes, loc, attn.double(), grad.double())
        with pytest.raises(ValueError, match="grad_out must be"):
            fn(value, shapes, loc, attn, grad[:, :4].contiguous())
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(value.cpu(), shapes, loc.cpu(), attn.cpu(), grad.cpu())
    with pytest.raises(ValueError, match="unknown ablation"):
        ablate(value, shapes, loc, attn, grad, out="nodx")
    with pytest.raises(ValueError, match="level 0"):  # 1 token, L * P = 4
        onlyg(value, ((1, 1), (3, 5)), torch.rand(1, 5, 2, 2, 2, 2, device=cuda),
              torch.rand(1, 5, 2, 2, 2, device=cuda), grad)
    G = torch.randn(2, 5, 16, device=cuda)
    with pytest.raises(TypeError):
        xdot(G.bfloat16(), shapes, loc, attn)
    with pytest.raises(ValueError, match="G must be"):
        xdot(G[:, :4].contiguous(), shapes, loc, attn)
    with pytest.raises(ValueError, match="contiguous"):
        xdot(G.transpose(0, 1).contiguous().transpose(0, 1), shapes, loc, attn)
    with pytest.raises(ValueError, match="CUDA tensors"):
        xdot(G.cpu(), shapes, loc, attn)
    # what only the C entries refuse, through the launch's error code
    with pytest.raises(RuntimeError, match="D <= 116"):
        onlyg(torch.randn(1, 16, 2, 128, device=cuda), shapes, loc, attn,
              torch.randn(1, 5, 256, device=cuda))
    with pytest.raises(RuntimeError, match="S <= 12288"):
        xdot(torch.randn(2, 5, 111 * 111, device=cuda), ((111, 111),), loc, attn)
    x = torch.randn(16, 32, device=cuda)
    with pytest.raises(TypeError):
        msda_cuda.lane_slice_cuda(x.double(), 2, 16)
    with pytest.raises(ValueError, match="M\\*W"):
        msda_cuda.lane_slice_cuda(x, 4, 16)
    idx = torch.zeros(16, 32, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        msda_cuda.take_along_axis_cuda(x, idx.long(), 1)
    with pytest.raises(ValueError, match="one 2-D or 3-D shape"):
        msda_cuda.take_along_axis_cuda(x, idx[:8].contiguous(), 1)
    with pytest.raises(ValueError, match="last two axes"):
        msda_cuda.take_along_axis_cuda(x[None].contiguous(), idx[None].contiguous(), 0)
