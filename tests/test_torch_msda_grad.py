"""The port's MSDA gradients against the JAX package's.

`ms_deform_attn_torch_backward` -- the plain version of the CUDA backward
kernel, which the port runs for CPU tensors -- and the autograd Function
around the op are held against `jax.grad` of the JAX gather form
(`impl="xla"`, its custom VJP `_msda_bwd`) and of the TPU kernels
interpreted on the CPU (`impl="pallas"`): the dense `_bwd_kernel` (K3, the
float32 default) and, with `UVHAND_MSDA_SEP_BWD=force`, the separable
`_bwd_kernel_sep` (K2). Inputs come from a numpy seed.

Tolerance: 1e-4 relative to each gradient's max, as the JAX package holds
its own kernels against each other (`tests/test_msda_pallas.py`); the
separable kernel's float32 folds carry ~2^-16 relative quantization. The
CUDA kernel itself runs only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvhand_tpu.ops import msda_pallas
from uvhand_tpu.ops.msda import ms_deform_attn as jax_msda
from uvhand_tpu_torch.ops.msda import (ms_deform_attn, ms_deform_attn_torch,
                                       ms_deform_attn_torch_backward)

from test_torch_msda import CASES, make_inputs

INTEGER_SHAPES = ((4, 8), (2, 4))  # powers of two: (cell + 0.5) / size is exact


def integer_inputs(seed=2, b=1, lq=5, m=2, d=8, p=2):
    """Every sample on an exact pixel centre: each tent's kink."""
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in INTEGER_SHAPES)
    value = rng.standard_normal((b, S, m, d)).astype(np.float32)
    hw = np.array([[w, h] for h, w in INTEGER_SHAPES])
    cells = rng.integers(0, hw[None, None, None, :, None, :], size=(b, lq, m, 2, p, 2))
    loc = ((cells + 0.5) / hw[None, None, None, :, None, :]).astype(np.float32)
    logits = rng.standard_normal((b, lq, m, 2 * p))
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, loc, attn.reshape(b, lq, m, 2, p).astype(np.float32)


ALL = dict(CASES, integer_exact=None)


def case_inputs(case):
    if case == "integer_exact":
        return (*integer_inputs(), INTEGER_SHAPES)
    b, lq, m, d, p, shapes, (lo, hi) = CASES[case]
    return (*make_inputs(0, b, lq, m, d, p, shapes, lo, hi), shapes)


@pytest.fixture
def pallas_bwd(monkeypatch):
    """Select the TPU backward kernel for the next trace. JAX memoizes the
    traced custom-VJP backward, so the caches are cleared before and after
    (as `tests/test_msda_pallas.py` does)."""

    def clear():
        jax.clear_caches()
        msda_pallas._bwd_partitioned.cache_clear()
        msda_pallas._bwd_fac_partitioned.cache_clear()

    def select(kernel, shapes):
        clear()
        monkeypatch.setenv("UVHAND_MSDA_FAC", "0")
        monkeypatch.setenv("UVHAND_MSDA_SEP_BWD", "force" if kernel == "sep" else "0")
        assert msda_pallas._separable_ok(shapes, jnp.float32) == (kernel == "sep")

    yield select
    clear()


# K2 (separable) takes sides <= 128 only; the JAX gather form is wrong at a
# level side of one (ROADMAP Queue 3), so that case is held against the
# kernels only
PAIRS = [(case, impl) for case in sorted(ALL) for impl in ("xla", "dense", "sep")
         if not (case == "side_over_128" and impl == "sep")
         and not (case == "side_of_one" and impl == "xla")]


@pytest.mark.parametrize("case,impl", PAIRS)
def test_gradients_match_jax(case, impl, pallas_bwd):
    value, loc, attn, shapes = case_inputs(case)
    (b, lq, m), d = loc.shape[:3], value.shape[-1]
    g = np.random.default_rng(1).standard_normal((b, lq, m * d)).astype(np.float32)

    if impl != "xla":
        pallas_bwd(impl, shapes)
    jimpl = "xla" if impl == "xla" else "pallas"
    # one jitted program: compiles faster than the op-by-op interpretation
    ref = jax.jit(jax.grad(lambda v, lc, a: jnp.sum(jax_msda(v, shapes, lc, a, impl=jimpl) * g),
                           argnums=(0, 1, 2)))(jnp.asarray(value), jnp.asarray(loc),
                                               jnp.asarray(attn))

    plain = ms_deform_attn_torch_backward(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                          torch.from_numpy(attn), torch.from_numpy(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (value, loc, attn)]
    (ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2]) * torch.from_numpy(g)).sum().backward()
    for name, r, ours, via_autograd in zip(("dvalue", "dloc", "dattn"), ref, plain, leaves):
        r = np.asarray(r)
        tol = 1e-4 * np.abs(r).max()
        np.testing.assert_allclose(ours.numpy(), r, rtol=0, atol=tol, err_msg=name)
        np.testing.assert_allclose(via_autograd.grad.numpy(), r, rtol=0, atol=tol, err_msg=name)


def test_integer_exact_case_pins_the_kink():
    """At an integer pixel coordinate the far corner's tent is 0 and JAX
    gives it no gradient; autograd through the plain forward's `abs` would
    (the reason the op has its own backward)."""
    value, loc, attn, shapes = case_inputs("integer_exact")
    g = np.random.default_rng(1).standard_normal((1, 5, 16)).astype(np.float32)
    ref = np.asarray(jax.grad(
        lambda lc: jnp.sum(jax_msda(jnp.asarray(value), shapes, lc, jnp.asarray(attn),
                                    impl="xla") * g))(jnp.asarray(loc)))
    ours = ms_deform_attn_torch_backward(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                         torch.from_numpy(attn), torch.from_numpy(g))[1]
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    tl = torch.from_numpy(loc).requires_grad_()
    (ms_deform_attn_torch(torch.from_numpy(value), shapes, tl, torch.from_numpy(attn))
     * torch.from_numpy(g)).sum().backward()
    assert np.abs(tl.grad.numpy() - ref).max() > 1e-2 * np.abs(ref).max()


def test_gradcheck_float64():
    """The Function's backward against finite differences, in float64, at
    random (non-integer) coordinates away from the kinks."""
    shapes = ((5, 4), (3, 3))
    value, loc, attn = make_inputs(3, 1, 4, 2, 3, 2, shapes, 0.05, 0.95)
    args = [torch.from_numpy(x).double().requires_grad_() for x in (value, loc, attn)]
    assert torch.autograd.gradcheck(
        lambda v, lc, a: ms_deform_attn(v, shapes, lc, a), args, eps=1e-6, atol=1e-6)


def test_no_grad_bypasses_the_function():
    value, loc, attn, shapes = case_inputs("in_range")
    v = torch.from_numpy(value).requires_grad_()
    with torch.no_grad():
        out = ms_deform_attn(v, shapes, torch.from_numpy(loc), torch.from_numpy(attn))
    assert out.grad_fn is None
    out = ms_deform_attn(v, shapes, torch.from_numpy(loc), torch.from_numpy(attn))
    assert type(out.grad_fn).__name__ == "MSDeformAttnFunctionBackward"
