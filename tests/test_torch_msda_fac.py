"""The port's factorized MSDA formulation against the JAX package's.

`ms_deform_attn_fac_torch` and `ms_deform_attn_fac_torch_backward` -- the
plain versions of the CUDA kernels `csrc/msda_fac_fwd.cu` and
`csrc/msda_fac_bwd.cu`, which the port runs for CPU tensors -- and autograd
through `MSDeformAttnFunction` with `UVHAND_MSDA_FAC=1` are held against the
JAX package's `impl="pallas"` with `UVHAND_MSDA_FAC=1`: the TPU kernels
`_fwd_kernel_fac` and `_bwd_kernel_fac`, interpreted on the CPU. Inputs come
from a numpy seed; the cases are those of `test_torch_msda.CASES` on which
`_fac_ok` holds, plus the integer-exact one (every sample on a tent's kink).

Every case runs in float32, three of them in bfloat16 too. Tolerances,
relative to each tensor's max: float32 forward 1e-5 and
gradients 1e-4 (sums in another order, as `test_torch_msda_grad.py`);
bfloat16 2e-2 (the same rounding points, whose float32 sums may round to
the neighbouring bf16 value).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvhand_tpu.ops import msda_pallas
from uvhand_tpu.ops.msda import ms_deform_attn as jax_msda
from uvhand_tpu_torch.ops import msda_cuda
from uvhand_tpu_torch.ops.msda import (fac_ok, ms_deform_attn, ms_deform_attn_fac_torch,
                                       ms_deform_attn_fac_torch_backward,
                                       ms_deform_attn_torch_backward)

from test_torch_msda import CASES
from test_torch_msda_grad import case_inputs

# side_over_128 is the one case the factorized kernels do not take
FAC_CASES = sorted([c for c in CASES if c != "side_over_128"] + ["integer_exact"])
#: name: (JAX type, torch type, forward tolerance, gradient tolerance)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 2e-2)}


def _clear():
    jax.clear_caches()
    msda_pallas._bwd_partitioned.cache_clear()
    msda_pallas._bwd_fac_partitioned.cache_clear()
    msda_pallas._fwd_fac_partitioned.cache_clear()


@pytest.fixture
def fac_env(monkeypatch):
    """UVHAND_MSDA_FAC=1 for both packages. JAX reads it when it traces and
    memoizes the traced custom-VJP backward, so its caches are cleared
    before and after (as `tests/test_msda_pallas.py` does)."""
    _clear()
    monkeypatch.setenv("UVHAND_MSDA_FAC", "1")
    yield
    _clear()


# bf16 on the cases whose structure differs (samples off the map, D=71 in
# three chunks of 32 lanes, integer-exact kinks); every case in float32.
# The bf16 rounding points do not depend on the case, and each case's
# interpreted JAX program takes seconds to compile.
BF16_CASES = ("integer_exact", "odd_d_wide", "out_of_range")
PAIRS = [(case, dtype) for case in FAC_CASES for dtype in sorted(DTYPES)
         if dtype == "float32" or case in BF16_CASES]


@pytest.mark.parametrize("case,dtype", PAIRS)
def test_fac_matches_jax_fac_kernels(case, dtype, fac_env):
    value, loc, attn, shapes = case_inputs(case)
    jdt, tdt, fwd_tol, grad_tol = DTYPES[dtype]
    (b, lq, m), d = loc.shape[:3], value.shape[-1]
    assert fac_ok(shapes, d) and msda_pallas._fac_ok(shapes, d)
    g = np.random.default_rng(1).standard_normal((b, lq, m * d)).astype(np.float32)
    # the inputs as the working type holds them, so both sides see the same numbers
    to_t = lambda x: torch.from_numpy(x).to(tdt)
    value_t, attn_t, g_t = to_t(value), to_t(attn), to_t(g)
    value_j, attn_j, g_j = (jnp.asarray(x.float().numpy(), jdt) for x in (value_t, attn_t, g_t))

    def fwd_vjp(v, lc, a):
        out, vjp = jax.vjp(lambda v, lc, a: jax_msda(v, shapes, lc, a, impl="pallas"), v, lc, a)
        return out, vjp(g_j)

    ref_out, ref_grads = jax.jit(fwd_vjp)(value_j, jnp.asarray(loc), attn_j)

    out = ms_deform_attn_fac_torch(value_t, shapes, torch.from_numpy(loc), attn_t)
    assert out.dtype == tdt
    ref_out = np.asarray(ref_out.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref_out, rtol=0,
                               atol=fwd_tol * np.abs(ref_out).max(), err_msg="forward")

    plain = ms_deform_attn_fac_torch_backward(value_t, shapes, torch.from_numpy(loc), attn_t, g_t)
    leaves = [value_t.clone().requires_grad_(), torch.from_numpy(loc).requires_grad_(),
              attn_t.clone().requires_grad_()]
    (ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2]).float() * g_t.float()).sum().backward()
    for name, r, ours, via_autograd, want in zip(("dvalue", "dloc", "dattn"), ref_grads, plain,
                                                 leaves, (tdt, torch.float32, tdt)):
        r = np.asarray(r.astype(jnp.float32))
        tol = grad_tol * np.abs(r).max()
        assert ours.dtype == want, name
        np.testing.assert_allclose(ours.float().numpy(), r, rtol=0, atol=tol, err_msg=name)
        np.testing.assert_allclose(via_autograd.grad.float().numpy(), r, rtol=0, atol=tol,
                                   err_msg=name)


def test_fac_ok_matches_jax(monkeypatch):
    shape_sets = [
        (((28, 28), (14, 14), (7, 7), (4, 4)), 32),   # arctic_sf at 224x224: WD 1792
        (((2, 130),), 8),                             # a side over 128
        (((130, 2),), 8),
        (((128, 128),), 32),                          # WD 4096: the largest that fits
        (((64, 100), (32, 50)), 32),                  # WD 3200 + 1664 > 4096
        (((6, 5), (3, 3), (2, 2)), 8),
        (((4, 4),), 71),
        (((6, 5), (2, 1), (1, 1)), 8),
    ]
    for env in ("0", "1", ""):
        monkeypatch.setenv("UVHAND_MSDA_FAC", env)
        for shapes, d in shape_sets:
            assert fac_ok(shapes, d) == msda_pallas._fac_ok(shapes, d), (env, shapes, d)
    monkeypatch.setenv("UVHAND_MSDA_FAC", "1")
    assert fac_ok(((128, 128),), 32) and not fac_ok(((64, 100), (32, 50)), 32)
    assert not fac_ok(((2, 130),), 8)
    monkeypatch.delenv("UVHAND_MSDA_FAC")
    assert not fac_ok(((4, 4),), 8)


def test_backward_takes_the_formulation_of_its_forward(monkeypatch):
    """The forward stores which formulation it ran: a knob flipped between
    forward and backward changes nothing. bf16, where the two formulations'
    rounding points make their gradients differ."""
    value, loc, attn, shapes = case_inputs("in_range")
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (*loc.shape[:2], loc.shape[2] * value.shape[-1])).astype(np.float32)).bfloat16()
    value_t, attn_t, loc_t = (torch.from_numpy(value).bfloat16(),
                              torch.from_numpy(attn).bfloat16(), torch.from_numpy(loc))
    fac = ms_deform_attn_fac_torch_backward(value_t, shapes, loc_t, attn_t, g)
    gather = ms_deform_attn_torch_backward(value_t, shapes, loc_t, attn_t, g)
    assert any(not torch.equal(a, b) for a, b in zip(fac, gather))
    for first, then, want in (("1", "0", fac), ("0", "1", gather)):
        leaves = [t.clone().requires_grad_() for t in (value_t, loc_t, attn_t)]
        monkeypatch.setenv("UVHAND_MSDA_FAC", first)
        out = ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
        monkeypatch.setenv("UVHAND_MSDA_FAC", then)
        out.backward(g)
        for leaf, w in zip(leaves, want):
            assert torch.equal(leaf.grad, w)


def test_dispatch_cpu_tensors_take_the_fac_plain_version(monkeypatch):
    value, loc, attn, shapes = case_inputs("odd_d")
    args = (torch.from_numpy(value), shapes, torch.from_numpy(loc), torch.from_numpy(attn))
    before = (msda_cuda.ms_deform_attn_fac_cuda.launches, msda_cuda.ms_deform_attn_cuda.launches)
    monkeypatch.setenv("UVHAND_MSDA_FAC", "1")
    for impl in ("auto", "torch"):
        assert torch.equal(ms_deform_attn(*args, impl=impl), ms_deform_attn_fac_torch(*args))
    assert before == (msda_cuda.ms_deform_attn_fac_cuda.launches,
                      msda_cuda.ms_deform_attn_cuda.launches)


def test_fac_wrappers_reject_cpu_tensors():
    value, loc, attn, shapes = case_inputs("in_range")
    args = (torch.from_numpy(value), shapes, torch.from_numpy(loc), torch.from_numpy(attn))
    with pytest.raises(ValueError, match="CUDA tensors"):
        msda_cuda.ms_deform_attn_fac_cuda(*args)
    g = torch.zeros(*loc.shape[:2], loc.shape[2] * value.shape[-1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        msda_cuda.ms_deform_attn_fac_backward_cuda(*args, g)
