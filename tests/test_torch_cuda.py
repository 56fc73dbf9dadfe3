"""The CUDA MSDA kernel against its plain version, on the card.

The kernel has no CPU mode, so these tests are marked `cuda` and skip where
no card is present. On a machine with one (which need not have JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: 1e-5 relative to max|value| in float32 (the kernel is built
without fused multiply-add and matches bit for bit in practice) and 2e-2 in
bfloat16.
"""

import pytest
import torch

from uvhand_tpu_torch.ops import msda_cuda
from uvhand_tpu_torch.ops.msda import ms_deform_attn, ms_deform_attn_torch

CASES = {
    # name: (b, lq, m, d, p, shapes, loc range)
    "encoder": (2, 1045, 8, 32, 4, ((28, 28), (14, 14), (7, 7), (4, 4)), (0.0, 1.0)),
    "decoder": (2, 300, 8, 32, 4, ((28, 28), (14, 14), (7, 7), (4, 4)), (-1.0, 1.0)),
    "out_of_range": (2, 64, 2, 8, 3, ((5, 4), (3, 2)), (-2.0, 3.0)),
    "odd_d": (1, 50, 2, 71, 2, ((6, 4), (3, 2)), (-0.2, 1.2)),
    "side_over_128": (1, 90, 2, 8, 2, ((2, 130), (150, 3)), (-0.1, 1.1)),
    "side_of_one": (2, 70, 2, 8, 2, ((6, 5), (2, 1), (1, 1)), (0.0, 1.0)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case, dtype):
    b, lq, m, d, p, shapes, (lo, hi) = CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(0)
    S, L = sum(h * w for h, w in shapes), len(shapes)
    value = torch.randn(b, S, m, d, generator=gen, device=cuda).to(dtype)
    loc = lo + (hi - lo) * torch.rand(b, lq, m, L, p, 2, generator=gen, device=cuda)
    attn = torch.randn(b, lq, m, L * p, generator=gen, device=cuda).softmax(-1)
    attn = attn.view(b, lq, m, L, p).to(dtype)

    before = msda_cuda.ms_deform_attn_cuda.launches
    out = ms_deform_attn(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert msda_cuda.ms_deform_attn_cuda.launches == before + 1
    ref = ms_deform_attn_torch(value, shapes, loc, attn)
    assert out.dtype == dtype and out.shape == (b, lq, m * d)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * value.float().abs().max().item()


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
