"""The CUDA MSDA kernels against their plain versions, on the card.

The kernels have no CPU mode, so these tests are marked `cuda` and skip where
no card is present. On a machine with one (which need not have JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: forward 1e-5 relative to max|value| in float32 (the kernel is
built without fused multiply-add and matches bit for bit in practice) and
2e-2 in bfloat16. Backward 1e-5 relative to each gradient's max in float32
(dvalue is summed by atomics in no fixed order) and 2e-2 in bfloat16.
"""

import pytest
import torch

from uvhand_tpu_torch.ops import msda_cuda
from uvhand_tpu_torch.ops.msda import (ms_deform_attn, ms_deform_attn_torch,
                                       ms_deform_attn_torch_backward)

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
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case, dtype):
    value, shapes, loc, attn, _ = make_inputs(case, dtype, cuda)
    b, lq, m, d = CASES[case][:4]
    before = msda_cuda.ms_deform_attn_cuda.launches
    out = ms_deform_attn(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert msda_cuda.ms_deform_attn_cuda.launches == before + 1
    ref = ms_deform_attn_torch(value, shapes, loc, attn)
    assert out.dtype == dtype and out.shape == (b, lq, m * d)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * value.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_kernel_matches_plain(cuda, case, dtype):
    value, shapes, loc, attn, gen = make_inputs(case, dtype, cuda)
    b, lq, m, d = CASES[case][:4]
    grad = torch.randn(b, lq, m * d, generator=gen, device=cuda).to(dtype)
    before = msda_cuda.ms_deform_attn_backward_cuda.launches
    ours = msda_cuda.ms_deform_attn_backward_cuda(value, shapes, loc, attn, grad)
    torch.cuda.synchronize()
    assert msda_cuda.ms_deform_attn_backward_cuda.launches == before + 1
    ref = ms_deform_attn_torch_backward(value, shapes, loc, attn, grad)
    for name, o, r, want in zip(("dvalue", "dloc", "dattn"), ours, ref,
                                (dtype, torch.float32, dtype)):
        assert o.dtype == want and o.shape == r.shape, name
        assert torch.isfinite(o.float()).all(), name
        err = (o.float() - r.float()).abs().max().item()
        assert err <= TOL[dtype] * max(r.float().abs().max().item(), 1e-12), (name, err)


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
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    shapes = ((4, 4),)
    value = torch.randn(1, 16, 2, 8, device=cuda)
    loc = torch.rand(1, 5, 2, 1, 2, 2, device=cuda)
    attn = torch.rand(1, 5, 2, 1, 2, device=cuda)
    with pytest.raises(TypeError):
        msda_cuda.ms_deform_attn_cuda(value.double(), shapes, loc, attn.double())
    with pytest.raises(ValueError, match="contiguous"):
        msda_cuda.ms_deform_attn_cuda(value.transpose(2, 3), shapes, loc, attn)
    with pytest.raises(ValueError, match="spatial_shapes"):
        msda_cuda.ms_deform_attn_cuda(value, ((4, 5),), loc, attn)


@pytest.mark.cuda
def test_backward_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    shapes = ((4, 4),)
    value = torch.randn(1, 16, 2, 8, device=cuda)
    loc = torch.rand(1, 5, 2, 1, 2, 2, device=cuda)
    attn = torch.rand(1, 5, 2, 1, 2, device=cuda)
    grad = torch.randn(1, 5, 16, device=cuda)
    bwd = msda_cuda.ms_deform_attn_backward_cuda
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
