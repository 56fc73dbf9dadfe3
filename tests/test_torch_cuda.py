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
float64 atomics, and float16 rounds them once). The DINO train step's
decoder call (Lq 498: 300 matching + 198 CDN queries, B = 16) goes
through the staged forward and backward kernels once each, the forward
bit for bit in float32. A temporal train step (a 2+2-layer model with each
temporal head, a window batch with centre-frame targets) launches the
staged kernels 4 + 4 times, and a SmoothNet step behind it, frozen, 4
forward and no backward. The AssemblyHands decoder's call (Lq 3 against the
1045 tokens of a 224x224 image, B = 16) goes through the staged kernels
like the DINO one. A 2+2-layer arctic_sf on a narrow Swin (the Swin-L
patched down to embed 32, depths 2/2/2/2, as `tests/test_torch_swin.py`
does) and a 1+2-layer `AssemblyDETR`, float32 at 128x128: their eval
outputs through the kernels within 1e-4 of those through the plain
versions, and a train step launches 4 + 4 (Swin) or 3 + 3 (AssemblyHands)
staged kernels and no general one.

The research kernels (`uvhand_tpu_torch/ops/msda_ablation.py`,
`uvhand_tpu_torch/ops/probes.py`), in float32 and bfloat16: the ablation
backward's dpy, dpx and daw and every output of `msda_xdot` bit-identical
to their plain versions, also where all points of a level sample one
location (shared corners, whose sums keep the (level, point) order), on rows
of odd length (unaligned row starts) and on rows longer than the kernel's
window; the ablation's dvalue (atomics) within 1e-5 of its max.
`msda_onlyg`, both kernels (tiled and general): daw bit-identical (it is
summed apart, in the plain version's order), dvalue (another summation
order) within 1e-5 of its max in float32 and from the general kernel, and
within 2.5e-4 of its max (the bench's ONLYG_BF16_TOL) from the tiled kernel
in bfloat16: there the tensor cores sum G in another order, so a G entry
can round to a neighbouring bf16 of the plain version's (7e-5 to 1.8e-4 of
dvalue's max measured on the H100), while a kernel that skipped rounding G
to bf16 would be off by more than the limit; each such case checks that
too. The probes exact: each kind of each probe's kernel (the gather's
staged and general, the lane slice's vec4 and general) bit-identical to its
plain version, out-of-range gather indices NaN in both gather kernels.
"""

import pytest
import torch

from uvhand_tpu_torch.ops import msda_ablation, msda_cuda, probes
from uvhand_tpu_torch.scripts import bench_msda_ablation
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
    """A case of CASES, or "bench": the research bench's timing inputs (its
    shapes, B=16, Lq=S=1045)."""
    if case == "bench":
        x = bench_msda_ablation.make_inputs(
            bench_msda_ablation.BENCH_SHAPES, **bench_msda_ablation.BENCH_DIMS, dtype=dtype,
            device=device, seed=0, lo=0.0, hi=1.0)
        return x["value"], x["shapes"], x["loc"], x["attn"], x["g"]
    value, shapes, loc, attn, gen = make_inputs(case, dtype, device)
    b, lq, m, d = CASES[case][:4]
    grad = torch.randn(b, lq, m * d, generator=gen, device=device).to(dtype)
    return value, shapes, loc, attn, grad


def xdot_inputs(case, dtype, device):
    """G, shapes, locations and attention for `msda_xdot`: an ablation case;
    "shared_corners", every point of a level at one location; "odd_rows",
    rows of S = 27 tokens (most row starts unaligned); "long_rows", rows of
    S = 111 * 111 tokens (the kernel's windows)."""
    special = {"shared_corners": "decoder", "odd_rows": "out_of_range"}
    if case == "long_rows":
        gen = torch.Generator(device=device).manual_seed(0)
        shapes = ((111, 111),)
        G = torch.randn(4, 5, 111 * 111, generator=gen, device=device).to(dtype)
        loc = torch.rand(2, 5, 2, 1, 3, 2, generator=gen, device=device)
        attn = torch.rand(2, 5, 2, 1, 3, generator=gen, device=device).to(dtype)
        return G, shapes, loc, attn
    value, shapes, loc, attn, grad = ablation_inputs(special.get(case, case), dtype, device)
    if case == "shared_corners":
        loc = loc[:, :, :, :, :1].expand(loc.shape).contiguous()
    if case == "odd_rows":  # ((5, 4), (3, 2)) and a level of 1x1: S = 27
        shapes = shapes + ((1, 1),)
        value = torch.cat([value, value[:, :1]], 1)
        loc = torch.cat([loc, loc[:, :, :, :1]], 3)
        attn = torch.cat([attn, attn[:, :, :, :1]], 3)
    return msda_ablation.dense_plane(value, grad), shapes, loc, attn


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
@pytest.mark.parametrize("case,kernel,kind", [
    # kernel None: the wrapper's plan; "general": the bench's hook
    ("decoder", None, "tiled"), ("decoder", "general", "general"),
    ("integer_exact", None, "tiled"),  # D = 16
    ("odd_d", None, "general"), ("side_over_128", None, "general"),  # D = 71, 8
    ("bench", None, "tiled"), ("bench", "general", "general"),
])
def test_onlyg_kernel_matches_plain(cuda, case, kernel, kind, dtype):
    args = ablation_inputs(case, dtype, cuda)
    wrapper = msda_cuda.ms_deform_attn_onlyg_cuda
    before = (wrapper.launches, msda_cuda.ONLYG_KINDS[kind].launches)
    got = wrapper(*args) if kernel is None else msda_cuda._launch_onlyg(kernel, *args)
    torch.cuda.synchronize()
    assert (wrapper.launches, msda_cuda.ONLYG_KINDS[kind].launches) == tuple(
        n + 1 for n in before)
    want = msda_ablation.onlyg_torch(*args)
    dv_tol = 1e-5
    if kind == "tiled" and dtype == torch.bfloat16:
        dv_tol = bench_msda_ablation.ONLYG_BF16_TOL
        # the limit must reject a kernel that skips rounding G to bf16
        unrounded = bench_msda_ablation.onlyg_unrounded_rel(args[0], args[4], want[0])
        rel = float((got[0] - want[0]).abs().max() / want[0].abs().max())
        print(f"{case}: bf16 dv rel {rel:.2e}, with G unrounded {unrounded:.2e}, "
              f"tol {dv_tol:.1e}")
        assert unrounded > dv_tol, unrounded
    for name, g, w in zip(("dv", "dpy", "dpx", "daw"), got, want):
        assert_matches(name, g, w, dv_tol if name == "dv" else 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", ABLATION_CASES + ["bench", "shared_corners", "odd_rows",
                                                   "long_rows"])
def test_xdot_kernel_matches_plain(cuda, case, dtype):
    G, shapes, loc, attn = xdot_inputs(case, dtype, cuda)
    wrapper = msda_cuda.ms_deform_attn_xdot_cuda
    before = wrapper.launches
    got = wrapper(G, shapes, loc, attn)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = msda_ablation.xdot_torch(G, shapes, loc, attn)
    for name, g, w in zip(("dpy", "dpx", "daw", "ws"), got, want):
        assert_matches(name, g, w, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_xdot_kernel_on_a_misaligned_plane(cuda, dtype):
    """A G whose data starts one element past a 16-byte boundary: every row
    start moves, and the kernel's vectors with it."""
    G, shapes, loc, attn = xdot_inputs("decoder", dtype, cuda)
    shifted = torch.empty(G.numel() + 1, dtype=dtype, device=cuda)[1:].view(G.shape)
    shifted.copy_(G)
    got = msda_cuda.ms_deform_attn_xdot_cuda(shifted, shapes, loc, attn)
    want = msda_ablation.xdot_torch(shifted, shapes, loc, attn)
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


def lane_input(Q, MW, cuda, offset=0):
    """x (Q, MW), `offset` floats into its storage (1: off 16 bytes)."""
    gen = torch.Generator(device=cuda).manual_seed(Q)
    base = torch.randn(Q * MW + 4, generator=gen, device=cuda)
    return base[offset:offset + Q * MW].view(Q, MW)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,M,W,offset,plan", [
    (1048, 8, 16, 0, "vec4"),  # the probe's shape
    (16 * 1048, 8, 16, 0, "vec4"),  # the MSDA call site's, B = 16
    (1049, 8, 16, 0, "vec4"),  # Q that no tile or wave divides
    (7, 3, 4, 0, "vec4"),  # fewer vectors than a block
    (1048, 8, 16, 1, "general"),  # x off 16 bytes
    (1048, 8, 6, 0, "general"),  # W % 4 != 0
], ids=str)
def test_lane_slice_kinds_match_plain(cuda, Q, M, W, offset, plan):
    x = lane_input(Q, M * W, cuda, offset)
    want = probes.lane_slice_torch(x, M, W)
    kinds = msda_cuda.LANE_SLICE_KINDS
    before = {k: c.launches for k, c in kinds.items()}
    got = msda_cuda.lane_slice_cuda(x, M, W)
    torch.cuda.synchronize()
    assert {k: c.launches - before[k] for k, c in kinds.items()} == {
        k: int(k == plan) for k in kinds}
    assert torch.equal(got, want)
    assert torch.equal(msda_cuda._launch_lane_slice("general", x, M, W), want)
    if plan == "vec4":
        assert torch.equal(msda_cuda._launch_lane_slice("vec4", x, M, W), want)
        msda_cuda.lane_slice_floor_cuda(x, M, W)  # the empty kernel launches
        torch.cuda.synchronize()
    else:
        with pytest.raises(ValueError, match="vec4 lane-slice kernel takes"):
            msda_cuda._launch_lane_slice("vec4", x, M, W)


def gather_inputs(shape, axis, cuda, offset=0):
    """v (normal) and idx (uniform over the gathered axis) of `shape`, each
    `offset` elements into its storage."""
    gen = torch.Generator(device=cuda).manual_seed(len(shape) * 1000 + shape[-1])
    n = 1
    for s in shape:
        n *= s
    v = torch.randn(n + 4, generator=gen, device=cuda)[offset:offset + n].view(shape)
    idx = torch.randint(0, shape[axis], (n + 4,), generator=gen, device=cuda,
                        dtype=torch.int32)[offset:offset + n].view(shape)
    return v, idx


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis,offset,plan,takes_staged", [
    # the probes' cases (the largest cut to 8 of its 16 blocks: 2096 chunks
    # of 4 rows, more than blocks x ring stages); under 2 MiB of values the
    # plan picks the general kernel, and the staged one is launched by name
    ((1408, 128), 0, 0, "general", False), ((1408, 128), 1, 0, "general", True),
    ((8, 1048, 128), 2, 0, "staged", True), ((1, 1048, 256), 2, 0, "general", True),
    ((1, 1048, 1408), 2, 0, "staged", True), ((8, 1048, 1408), 2, 0, "staged", True),
    ((128, 8, 128), 2, 0, "general", True),
    # a last chunk of one row (1049 = 262 x 4 + 1: a ring one stage full);
    # of 3 of 4 rows with 2-3 chunks a block; of 5 of 6 rows
    ((1, 1049, 1408), 2, 0, "staged", True), ((3, 1049, 1408), 2, 0, "staged", True),
    ((1, 1403, 128), 2, 0, "general", True),
    # fewer chunks than a block's ring; one row; rings of two and three stages
    ((1, 3, 128), 2, 0, "general", True), ((1, 1, 4), 2, 0, "general", True),
    ((2, 3, 29_052), 2, 0, "general", True), ((1, 5, 14_528), 2, 0, "general", True),
    # what the staged kernel does not take
    ((2, 300, 128), 2, 1, "general", False), ((8, 100, 130), 2, 0, "general", False),
    ((2, 3, 29_056), 2, 0, "general", False), ((3, 40, 1408), 1, 0, "general", False),
], ids=str)
def test_gather_kinds_match_plain(cuda, shape, axis, offset, plan, takes_staged):
    v, idx = gather_inputs(shape, axis, cuda, offset)
    want = probes.take_along_axis_torch(v, idx, axis)
    kinds = msda_cuda.GATHER_KINDS
    before = {k: c.launches for k, c in kinds.items()}
    got = msda_cuda.take_along_axis_cuda(v, idx, axis)
    torch.cuda.synchronize()
    assert {k: c.launches - before[k] for k, c in kinds.items()} == {
        k: int(k == plan) for k in kinds}
    assert torch.equal(got, want)
    assert torch.equal(msda_cuda._launch_gather("general", v, idx, axis), want)
    if takes_staged:
        assert torch.equal(msda_cuda._launch_gather("staged", v, idx, axis), want)
    else:
        with pytest.raises(ValueError, match="staged gather kernel takes"):
            msda_cuda._launch_gather("staged", v, idx, axis)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(msda_cuda.GATHER_KINDS))
def test_gather_kinds_give_nan_for_out_of_range_indices(cuda, kind):
    """An index out of range (negative, or at or past the row's end) gives
    NaN, never a read outside the row; the rest stay exact."""
    shape = (2, 37, 128)
    v, idx = gather_inputs(shape, 2, cuda)
    bad = torch.zeros(shape, dtype=torch.bool, device=cuda)
    for n, r, c, j in ((0, 0, 0, -1), (0, 5, 17, 128), (1, 36, 127, 1 << 30),
                       (1, 20, 64, -(1 << 30))):
        idx[n, r, c] = j
        bad[n, r, c] = True
    got = msda_cuda._launch_gather(kind, v, idx, 2)
    torch.cuda.synchronize()
    assert torch.isnan(got[bad]).all() and not torch.isnan(got[~bad]).any()
    want = probes.take_along_axis_torch(v, idx.clamp(0, 127), 2)
    assert torch.equal(got[~bad], want[~bad])


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
    with pytest.raises(ValueError, match="tiled onlyg kernel takes"):  # D = 8
        msda_cuda._launch_onlyg("tiled", value, shapes, loc, attn, grad)
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


@pytest.mark.cuda
def test_enc_lite_encoder_call_takes_the_staged_kernels(cuda):
    """An enc_lite low-resolution-only layer's MSDA call: the 261 queries of
    levels 1.. against all 1045 tokens of arctic_sf's levels, forward and
    backward, through the staged kernels, equal to the plain versions."""
    shapes = CASES["encoder"][5]
    gen = torch.Generator(device=cuda).manual_seed(0)
    value = torch.randn(2, 1045, 8, 32, generator=gen, device=cuda, requires_grad=True)
    loc = torch.rand(2, 261, 8, 4, 4, 2, generator=gen, device=cuda, requires_grad=True)
    attn = torch.randn(2, 261, 8, 16, generator=gen, device=cuda).softmax(-1).view(
        2, 261, 8, 4, 4).requires_grad_()
    grad = torch.randn(2, 261, 256, generator=gen, device=cuda)
    before = (msda_cuda.FWD_STAGED.launches, msda_cuda.BWD_STAGED.launches,
              msda_cuda.FWD_GENERAL.launches, msda_cuda.BWD_GENERAL.launches)
    out = ms_deform_attn(value, shapes, loc, attn)
    out.backward(grad)
    torch.cuda.synchronize()
    after = (msda_cuda.FWD_STAGED.launches, msda_cuda.BWD_STAGED.launches,
             msda_cuda.FWD_GENERAL.launches, msda_cuda.BWD_GENERAL.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 0, 0]
    with torch.no_grad():
        ref = ms_deform_attn_torch(value, shapes, loc, attn)
        refs = ms_deform_attn_torch_backward(value, shapes, loc, attn, grad)
    assert torch.equal(out.detach(), ref)
    for got, want in zip((value.grad, loc.grad, attn.grad), refs):
        assert (got - want).abs().max().item() <= TOL[torch.float32] * want.abs().max().item()


@pytest.mark.cuda
def test_remat_train_step_gradients_equal_the_plain_step(cuda, tmp_path):
    """A train pass of a small model (dropout 0.1, feature mask 0.3) with
    remat and without, from the same weights and generator seed: the same
    losses, the generator at the same state after, every gradient outside
    the backbone within 1e-3 of its max and the backbone's within 1e-3 in
    relative L2 error (the backward kernel's float32 dvalue is summed by
    atomics in no fixed order and cuDNN's weight gradients are not
    bit-repeatable; 50 random ResNet layers carry that to single elements
    of the backbone's gradients; a recompute that drew other dropout masks
    moves the gradients by their own size), and remat's launches: each
    layer's forward kernel twice, its backward once."""
    from uvhand_tpu_torch import engine
    from uvhand_tpu_torch.data import arctic
    from uvhand_tpu_torch.geometry import mano, objects
    from uvhand_tpu_torch.models.detr import UVHandDETR

    bank = objects.synthetic_object_bank(2, device="cpu")
    arctic.make_synthetic_root(str(tmp_path / "arctic"), num_seqs=1, frames=2, views=1,
                               obj_bank=bank)
    ds = arctic.ArcticDataset(str(tmp_path / "arctic"), "p1", "train", aug=False,
                              kp3d_cano=bank.kp_bottom.numpy(), img_res=128)
    batch = engine.to_device(arctic.collate([ds[0], ds[1]]), cuda, engine.TRAIN_KEYS)
    world = (mano.synthetic_mano(0, True, device=cuda), mano.synthetic_mano(1, False, device=cuda),
             objects.synthetic_object_bank(2, device=cuda))
    runs = {}
    for remat in (False, True):
        model = UVHandDETR(num_queries=12, num_encoder_layers=2, num_decoder_layers=2,
                           d_model=64, n_heads=4, dim_feedforward=128, remat=remat,
                           generator=torch.Generator().manual_seed(0), device=cuda).train()
        gen = torch.Generator(device=cuda).manual_seed(3)
        before = (msda_cuda.FWD_STAGED.launches, msda_cuda.BWD_STAGED.launches)
        total, ld = engine.make_loss_fn(model, *world, img_res=128.0)(batch, gen)
        total.backward()
        torch.cuda.synchronize()
        launches = (msda_cuda.FWD_STAGED.launches - before[0],
                    msda_cuda.BWD_STAGED.launches - before[1])
        runs[remat] = ({k: float(v.detach()) for k, v in ld.items()},
                       {n: p.grad for n, p in model.named_parameters()}, gen.get_state(),
                       launches)
    (ld0, g0, s0, n0), (ld1, g1, s1, n1) = runs[False], runs[True]
    assert n0 == (4, 4) and n1 == (8, 4)
    assert ld0 == ld1 and torch.equal(s0, s1)
    backbone = [n for n in g0 if n.startswith("backbone.")]
    for n, g in g0.items():
        if n not in backbone:
            err = (g1[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
            assert err <= 1e-3, (n, err)
    l2 = sum(((g1[n] - g0[n]).double() ** 2).sum().item() for n in backbone)
    assert (l2 / sum((g0[n].double() ** 2).sum().item() for n in backbone)) ** 0.5 <= 1e-3


@pytest.mark.cuda
def test_nccl_world_one_step_equals_the_plain_step(cuda, tmp_path):
    """`init_multihost` at world size 1 under NCCL (explicit arguments, a
    free port), then one SGD step (lr 1, no clip: the parameters move by the
    gradient) of a small model through `make_fused_train_step` with the
    process group (the gather and the all-reduce run, each an identity at
    world size 1) and without it, from the same weights: the same loss dict
    but grad_norm, which with every gradient is within 1e-3 (relative, and
    of each tensor's max outside the backbone, in relative L2 error in it:
    the backward kernel's dvalue atomics and cuDNN's weight gradients are
    not bit-repeatable, as the remat test above says), and the same
    launches, 4 forward + 4 backward kernels a step."""
    import datetime
    import socket

    from uvhand_tpu_torch import engine
    from uvhand_tpu_torch.data import arctic
    from uvhand_tpu_torch.geometry import mano, objects
    from uvhand_tpu_torch.models.detr import UVHandDETR
    from uvhand_tpu_torch.train import launch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    info = launch.init_multihost(f"127.0.0.1:{port}", 1, 0, timeout_s=120)
    try:
        assert torch.distributed.get_backend() == "nccl"
        assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                        "global_devices": 1}
        bank = objects.synthetic_object_bank(2, device="cpu")
        arctic.make_synthetic_root(str(tmp_path / "arctic"), num_seqs=1, frames=2, views=1,
                                   obj_bank=bank)
        ds = arctic.ArcticDataset(str(tmp_path / "arctic"), "p1", "train", aug=False,
                                  kp3d_cano=bank.kp_bottom.numpy(), img_res=128)
        batch = engine.to_device(arctic.collate([ds[0], ds[1]]), cuda, engine.TRAIN_KEYS)
        world = (mano.synthetic_mano(0, True, device=cuda),
                 mano.synthetic_mano(1, False, device=cuda),
                 objects.synthetic_object_bank(2, device=cuda))
        runs = {}
        for group in (None, torch.distributed.group.WORLD):
            model = UVHandDETR(num_queries=12, num_encoder_layers=2, num_decoder_layers=2,
                               d_model=64, n_heads=4, dim_feedforward=128, dropout=0.0,
                               feature_mask_ratio=0.0,
                               generator=torch.Generator().manual_seed(0), device=cuda)
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            step = engine.make_fused_train_step(
                model, *world, torch.optim.SGD(model.parameters(), lr=1.0), img_res=128.0,
                clip_max_norm=0.0, device=cuda, process_group=group)
            counts = (msda_cuda.FWD_STAGED.launches, msda_cuda.BWD_STAGED.launches)
            ld = {k: float(v) for k, v in step(batch).items()}
            torch.cuda.synchronize()
            counts = (msda_cuda.FWD_STAGED.launches - counts[0],
                      msda_cuda.BWD_STAGED.launches - counts[1])
            runs[group is None] = (ld, {n: before[n] - p.detach()
                                        for n, p in model.named_parameters()}, counts)
        (ld0, g0, n0), (ld1, g1, n1) = runs[True], runs[False]
        assert n0 == n1 == (4, 4)
        norm = ld0.pop("grad_norm"), ld1.pop("grad_norm")
        assert ld0 == ld1 and abs(norm[1] - norm[0]) <= 1e-3 * norm[0]
        backbone = [n for n in g0 if n.startswith("backbone.")]
        for n, g in g0.items():
            if n not in backbone:
                err = (g1[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                assert err <= 1e-3, (n, err)
        l2 = sum(((g1[n] - g0[n]).double() ** 2).sum().item() for n in backbone)
        assert (l2 / sum((g0[n].double() ** 2).sum().item() for n in backbone)) ** 0.5 <= 1e-3
    finally:
        torch.distributed.destroy_process_group()


#: the DINO decoder's cross-attention call: 300 matching + 198 CDN queries
#: (`dn_number` 100: 33 groups x 2 x 3 slots), B = 16, at the main path's
#: levels
DN_DECODER = (16, 498, 8, 32, 4, ((28, 28), (14, 14), (7, 7), (4, 4)), (-1.0, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_dn_decoder_call_through_the_staged_kernels(cuda, dtype, monkeypatch):
    """The Lq-498 decoder call of the DINO train step goes through the
    staged forward and backward kernels (K1, and K3 or in bfloat16 K2), with
    the forward bit for bit in float32 and the backward within TOL of the
    plain version, and `ms_deform_attn` launches each once."""
    monkeypatch.setitem(CASES, "dn_decoder", DN_DECODER)
    value, shapes, loc, attn, gen = make_inputs("dn_decoder", dtype, cuda)
    b, lq, m, d = DN_DECODER[:4]
    grad = torch.randn(b, lq, m * d, generator=gen, device=cuda).to(dtype)
    assert msda_cuda.staged_plan(shapes, d, dtype) is not None
    assert msda_cuda.staged_plan(shapes, d, dtype, backward=True) is not None
    counts = (msda_cuda.FWD_STAGED, msda_cuda.BWD_STAGED, msda_cuda.FWD_GENERAL,
              msda_cuda.BWD_GENERAL)
    before = [c.launches for c in counts]
    v, lo, at = (x.clone().requires_grad_() for x in (value, loc.float(), attn))
    out = ms_deform_attn(v, shapes, lo, at)
    out.backward(grad)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counts, before)] == [1, 1, 0, 0]
    ref = ms_deform_attn_torch(value, shapes, loc, attn)
    if dtype == torch.float32:
        assert torch.equal(out.detach(), ref)
    else:
        assert_matches("out", out.detach(), ref, TOL[dtype])
    ref_grads = ms_deform_attn_torch_backward(value, shapes, loc, attn, grad)
    grads = (v.grad, lo.grad, at.grad)
    for name, o, r in zip(("dvalue", "dloc", "dattn"), grads, ref_grads):
        assert_matches(name, o, r, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lstm", "vivit"])
def test_temporal_train_and_smoothnet_steps_launch_the_staged_kernels(cuda, kind, tmp_path):
    """A window batch (2 `TempoTrainDataset` windows of 4 frames, the centre
    frames' targets) through `make_fused_train_step` of a 2+2-layer model
    with the `kind` temporal head: 4 staged forward and 4 staged backward
    launches, no general one, every loss finite and the `/temporal` terms
    there; then one `make_smoothnet_train_step` step behind the same model,
    frozen: 4 staged forward launches and no backward, the base unchanged,
    the smoother moved."""
    from functools import partial

    from uvhand_tpu_torch import engine
    from uvhand_tpu_torch.data import arctic
    from uvhand_tpu_torch.geometry import mano, objects
    from uvhand_tpu_torch.models.detr import UVHandDETR
    from uvhand_tpu_torch.train import smoothnet_driver
    from uvhand_tpu_torch.train.state import create_optimizer

    bank = objects.synthetic_object_bank(2, device="cpu")
    root = str(tmp_path / "arctic")
    arctic.make_synthetic_root(root, num_seqs=1, frames=6, views=1, obj_bank=bank,
                               image_hw=(150, 210))
    ds = arctic.ArcticDataset(root, "p1", "train", kp3d_cano=bank.kp_bottom.numpy(), img_res=128)
    tds = arctic.TempoTrainDataset(ds, 4, split_window=False)
    batch = partial(arctic.collate_tempo_train, split_window=False)([tds[1], tds[4]])
    wds = arctic.WindowDataset(ds, 4)
    windows = arctic.collate_windows([wds[0], wds[1]])
    world = (mano.synthetic_mano(0, True, device=cuda), mano.synthetic_mano(1, False, device=cuda),
             objects.synthetic_object_bank(2, device=cuda))
    model = UVHandDETR(num_queries=12, num_encoder_layers=2, num_decoder_layers=2, d_model=64,
                       n_heads=4, dim_feedforward=128, temporal_head=kind, temporal_window=4,
                       generator=torch.Generator().manual_seed(0), device=cuda)
    counts = (msda_cuda.FWD_STAGED, msda_cuda.BWD_STAGED, msda_cuda.FWD_GENERAL,
              msda_cuda.BWD_GENERAL)
    step = engine.make_fused_train_step(model, *world, create_optimizer(model), img_res=128.0,
                                        device=cuda)
    before = [c.launches for c in counts]
    ld = step(batch)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counts, before)] == [4, 4, 0, 0]
    assert all(torch.isfinite(v) for v in ld.values())
    assert "loss/mano/pose/r/temporal" in ld and "loss/cd/temporal" in ld

    smoother, opt = smoothnet_driver.create_smoother_state(
        4, generator=torch.Generator().manual_seed(1), device=cuda)
    sm_step = smoothnet_driver.make_smoothnet_train_step(model, smoother, opt, *world,
                                                         img_res=128.0, device=cuda)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    old = {n: p.detach().clone() for n, p in smoother.named_parameters()}
    before = [c.launches for c in counts]
    ld = sm_step(windows)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counts, before)] == [4, 0, 0, 0]
    assert torch.isfinite(ld["total"])
    assert all(torch.equal(v, base[k]) for k, v in model.state_dict().items())
    assert all(not torch.equal(p, old[n]) for n, p in smoother.named_parameters())


#: the AssemblyHands decoder's cross-attention call: 3 queries (left, right,
#: object), B = 16, at the levels of a 224x224 image
ASSEMBLY_DECODER = (16, 3, 8, 32, 4, ((28, 28), (14, 14), (7, 7), (4, 4)), (-0.5, 1.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_assembly_decoder_call_through_the_staged_kernels(cuda, dtype, monkeypatch):
    """The Lq-3 decoder call goes through the staged forward and backward
    kernels once each, the forward bit for bit in float32, the backward
    within TOL of the plain version."""
    monkeypatch.setitem(CASES, "assembly_decoder", ASSEMBLY_DECODER)
    value, shapes, loc, attn, gen = make_inputs("assembly_decoder", dtype, cuda)
    b, lq, m, d = ASSEMBLY_DECODER[:4]
    grad = torch.randn(b, lq, m * d, generator=gen, device=cuda).to(dtype)
    counts = (msda_cuda.FWD_STAGED, msda_cuda.BWD_STAGED, msda_cuda.FWD_GENERAL,
              msda_cuda.BWD_GENERAL)
    before = [c.launches for c in counts]
    v, lo, at = (x.clone().requires_grad_() for x in (value, loc.float(), attn))
    out = ms_deform_attn(v, shapes, lo, at)
    out.backward(grad)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counts, before)] == [1, 1, 0, 0]
    ref = ms_deform_attn_torch(value, shapes, loc, attn)
    if dtype == torch.float32:
        assert torch.equal(out.detach(), ref)
    else:
        assert_matches("out", out.detach(), ref, TOL[dtype])
    ref_grads = ms_deform_attn_torch_backward(value, shapes, loc, attn, grad)
    for name, o, r in zip(("dvalue", "dloc", "dattn"), (v.grad, lo.grad, at.grad), ref_grads):
        assert_matches(name, o, r, TOL[dtype])


def _set_impl(model, impl):
    from uvhand_tpu_torch.ops.msda import MSDeformAttn

    for mod in model.modules():
        if isinstance(mod, MSDeformAttn):
            mod.impl = impl


@pytest.mark.cuda
@pytest.mark.parametrize("model_kind", ["swin", "assembly"])
def test_swin_and_assembly_models_through_the_staged_kernels(cuda, model_kind, monkeypatch,
                                                            tmp_path):
    import numpy as np

    from uvhand_tpu_torch import engine
    from uvhand_tpu_torch.data import arctic
    from uvhand_tpu_torch.geometry import mano, objects
    from uvhand_tpu_torch.models.assembly import AssemblyDETR
    from uvhand_tpu_torch.models.backbones import swin
    from uvhand_tpu_torch.models.detr import UVHandDETR
    from uvhand_tpu_torch.train.state import create_optimizer

    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(-2, 2, (2, 128, 128, 3)).astype(np.float32)).to(cuda)
    if model_kind == "swin":
        monkeypatch.setattr(swin.SwinTransformer, "swin_l_384", classmethod(
            lambda cls, **kw: cls(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8),
                                  window_size=12, **kw)))
        monkeypatch.setattr(swin, "SWIN_L_CHANNELS", (64, 128, 256))
        model = UVHandDETR(num_queries=12, num_encoder_layers=2, num_decoder_layers=2,
                           d_model=64, n_heads=4, dim_feedforward=128,
                           backbone="swin_L_384_22k", generator=gen, device=cuda)
        per_pass = 4
    else:
        model = AssemblyDETR(d_model=64, num_encoder_layers=1, num_decoder_layers=2,
                             generator=gen, device=cuda)
        per_pass = 3
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("sampling_offsets.weight", "attention_weights.weight")):
                p.normal_(0.0, 0.05)
    counts = (msda_cuda.FWD_STAGED, msda_cuda.BWD_STAGED, msda_cuda.FWD_GENERAL,
              msda_cuda.BWD_GENERAL)
    outs = {}
    for impl in ("auto", "torch"):
        _set_impl(model, impl)
        before = [c.launches for c in counts]
        with torch.no_grad():
            outs[impl] = model(images)["stacked"]
        torch.cuda.synchronize()
        assert [c.launches - n for c, n in zip(counts, before)] == (
            [per_pass, 0, 0, 0] if impl == "auto" else [0, 0, 0, 0])
    for k, ref in outs["torch"].items():
        if isinstance(ref, torch.Tensor):
            err = float((outs["auto"][k] - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
            assert err <= 1e-4, (k, err)
    _set_impl(model, "auto")
    if model_kind == "swin":
        bank = objects.synthetic_object_bank(2, device="cpu")
        root = str(tmp_path / "arctic")
        arctic.make_synthetic_root(root, num_seqs=1, frames=2, views=1, obj_bank=bank,
                                   image_hw=(150, 210))
        ds = arctic.ArcticDataset(root, "p1", "train", kp3d_cano=bank.kp_bottom.numpy(),
                                  img_res=128)
        batch = arctic.collate([ds[0], ds[1]])
        world = (mano.synthetic_mano(0, True, device=cuda),
                 mano.synthetic_mano(1, False, device=cuda),
                 objects.synthetic_object_bank(2, device=cuda))
        step = engine.make_fused_train_step(model, *world, create_optimizer(model),
                                            img_res=128.0, device=cuda)
    else:
        step = engine.make_assembly_train_step(model, create_optimizer(model), device=cuda)
        batch = {"images": images, "labels": np.array([[9, 10, 3], [9, 10, 5]], np.int32),
                 "keypoints63": rng.uniform(size=(2, 3, 63)).astype(np.float32),
                 "target_valid": np.ones((2, 3), bool)}
    before = [c.launches for c in counts]
    ld = step(batch)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counts, before)] == [per_pass, per_pass, 0, 0]
    assert all(bool(torch.isfinite(v)) for v in ld.values()) and float(ld["grad_norm"]) > 0
