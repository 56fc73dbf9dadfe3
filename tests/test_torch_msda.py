"""The port's MSDA (`uvhand_tpu_torch/ops/msda.py`) against the JAX package.

`ms_deform_attn_torch` -- the plain version of the CUDA kernel, which is
what the port runs for CPU tensors -- is held against the JAX gather form
(`impl="xla"`) and against the TPU kernel `_fwd_kernel` itself
(`impl="pallas"`, interpreted on the CPU), on small inputs built from a numpy
seed. Tolerance: 1e-5 relative to max|value| in float32 (sums in another
order). The CUDA kernel runs only on the card (`chip_smoke.py`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvhand_tpu.ops.msda import MSDeformAttn as JaxMSDeformAttn
from uvhand_tpu.ops.msda import ms_deform_attn as jax_msda
from uvhand_tpu_torch.ops import msda_cuda
from uvhand_tpu_torch.ops.msda import MSDeformAttn, ms_deform_attn, ms_deform_attn_torch


def make_inputs(seed, b, lq, m, d, p, shapes, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.standard_normal((b, S, m, d)).astype(np.float32)
    loc = rng.uniform(lo, hi, size=(b, lq, m, L, p, 2)).astype(np.float32)
    logits = rng.standard_normal((b, lq, m, L * p)).astype(np.float32)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, loc, attn.reshape(b, lq, m, L, p).astype(np.float32)


CASES = {
    # name: (b, lq, m, d, p, shapes, loc range)
    "in_range": (2, 7, 2, 8, 2, ((6, 5), (3, 3), (2, 2)), (0.0, 1.0)),
    # decoder-style references in [-1, 1]: most samples fall off the map
    "out_of_range": (2, 9, 2, 8, 3, ((5, 4), (3, 2)), (-1.0, 2.0)),
    "odd_d": (1, 5, 2, 30, 2, ((6, 4), (3, 2)), (0.0, 1.0)),
    "odd_d_wide": (1, 4, 1, 71, 2, ((4, 4),), (0.0, 1.0)),
    "side_over_128": (1, 9, 2, 8, 2, ((2, 130),), (-0.1, 1.1)),
    "side_of_one": (2, 7, 2, 8, 2, ((6, 5), (2, 1), (1, 1)), (0.0, 1.0)),
}


def _run(case, seed=0):
    b, lq, m, d, p, shapes, (lo, hi) = CASES[case]
    value, loc, attn = make_inputs(seed, b, lq, m, d, p, shapes, lo, hi)
    ours = ms_deform_attn_torch(torch.from_numpy(value), shapes,
                                torch.from_numpy(loc), torch.from_numpy(attn)).numpy()
    return value, loc, attn, shapes, ours


# The JAX gather form (`impl="xla"`) clamps its 2x2 footprint start to
# [0, side - 2], which is -1 for a level side of 1, and is wrong there; the
# TPU kernel agrees with the port (and grid_sample), so that case is held
# against the kernel only.
PAIRS = [(case, impl) for case in sorted(CASES) for impl in ("xla", "pallas")
         if not (case == "side_of_one" and impl == "xla")]


@pytest.mark.parametrize("case,impl", PAIRS)
def test_plain_matches_jax(case, impl):
    value, loc, attn, shapes, ours = _run(case)
    ref = np.asarray(jax_msda(jnp.asarray(value), shapes, jnp.asarray(loc),
                              jnp.asarray(attn), impl=impl))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(value).max())


def test_out_of_range_samples_are_zero():
    """A sample whose four corners all lie off the map adds nothing; one that
    straddles the border keeps only its in-map corners."""
    shapes = ((3, 4),)
    value = np.random.default_rng(1).standard_normal((1, 12, 1, 4)).astype(np.float32)
    attn = np.ones((1, 3, 1, 1, 1), np.float32)
    # far off the map; straddling the left edge at row centre 1; in range
    loc = np.array([[-0.7, 1.9], [0.0, 0.5], [0.625, 0.5]], np.float32)
    loc = loc.reshape(1, 3, 1, 1, 1, 2)
    out = ms_deform_attn_torch(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                               torch.from_numpy(attn)).numpy()[0]
    v = value[0, :, 0].reshape(3, 4, 4)
    np.testing.assert_array_equal(out[0], 0.0)
    # px = -0.5: half of column 0 (its left neighbour is padding)
    np.testing.assert_allclose(out[1], 0.5 * v[1, 0], rtol=1e-6)
    # px = 2.0, py = 1.0: exactly one cell
    np.testing.assert_array_equal(out[2], v[1, 2])


def test_integer_exact_coordinates():
    """At px, py exact integers the tent is 1 at one corner and 0 at its
    neighbours: the output is the attention-weighted sum of single cells."""
    shapes = ((4, 8), (2, 4))  # powers of two: (cell + 0.5) / size is exact
    rng = np.random.default_rng(2)
    value = rng.standard_normal((1, 40, 2, 8)).astype(np.float32)
    # pixel (x, y) = (loc * size - 0.5) lands on integer cells
    cells = rng.integers(0, [4, 2], size=(1, 5, 2, 2, 2, 2))
    sizes = np.array([[8, 4], [4, 2]], np.float32)[None, None, None, :, None, :]
    loc = ((cells + 0.5) / sizes).astype(np.float32)
    logits = rng.standard_normal((1, 5, 2, 4)).astype(np.float32)
    attn = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).reshape(1, 5, 2, 2, 2)
    out = ms_deform_attn_torch(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                               torch.from_numpy(attn.astype(np.float32))).numpy()
    expect = np.zeros((1, 5, 2, 8), np.float64)
    starts = (0, 32)
    for q in range(5):
        for m in range(2):
            for lvl, (h, w) in enumerate(shapes):
                for p in range(2):
                    x, y = cells[0, q, m, lvl, p]
                    expect[0, q, m] += attn[0, q, m, lvl, p] * value[0, starts[lvl] + y * w + x, m]
    np.testing.assert_allclose(out, expect.reshape(1, 5, 16), rtol=1e-6, atol=1e-6)
    ref = np.asarray(jax_msda(jnp.asarray(value), shapes, jnp.asarray(loc),
                              jnp.asarray(attn.astype(np.float32)), impl="xla"))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_bf16_plain_accumulates_in_fp32():
    value, loc, attn, shapes, ref = _run("in_range")
    out = ms_deform_attn_torch(torch.from_numpy(value).bfloat16(), shapes,
                               torch.from_numpy(loc), torch.from_numpy(attn).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2 * np.abs(value).max())


def test_dispatch_cpu_tensors_take_plain_version():
    value, loc, attn, shapes, ours = _run("in_range")
    before = msda_cuda.ms_deform_attn_cuda.launches
    out = ms_deform_attn(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                         torch.from_numpy(attn))
    np.testing.assert_array_equal(out.numpy(), ours)
    assert msda_cuda.ms_deform_attn_cuda.launches == before


def test_cuda_wrapper_rejects_cpu_tensors():
    value, loc, attn, shapes, _ = _run("in_range")
    with pytest.raises(ValueError, match="CUDA tensors"):
        msda_cuda.ms_deform_attn_cuda(torch.from_numpy(value), shapes,
                                      torch.from_numpy(loc), torch.from_numpy(attn))


@pytest.mark.parametrize("ref_dim", [2, 42])
def test_layer_matches_jax(ref_dim):
    """MSDeformAttn with 2-d and 42-d (centre-refine) references, with the
    JAX layer's weights carried across."""
    rng = np.random.default_rng(7)
    C, M, L, P, B, Lq = 32, 4, 2, 2, 2, 6
    shapes = ((5, 6), (3, 3))
    S = sum(h * w for h, w in shapes)
    query = rng.standard_normal((B, Lq, C)).astype(np.float32)
    feats = rng.standard_normal((B, S, C)).astype(np.float32)
    refs = rng.uniform(-0.2, 1.2, size=(B, Lq, L, ref_dim)).astype(np.float32)
    pad = np.zeros((B, S), bool)
    pad[1, -5:] = True

    layer = JaxMSDeformAttn(C, L, M, P, impl="xla")
    params = layer.init(
        jax.random.PRNGKey(0), jnp.asarray(query), jnp.asarray(refs),
        jnp.asarray(feats), shapes, jnp.asarray(pad))["params"]
    # random offset / attention projections, so every query samples its own points
    params = dict(params)
    for name in ("sampling_offsets", "attention_weights"):
        k = np.asarray(params[name]["kernel"])
        params[name] = {"kernel": jnp.asarray(rng.normal(scale=0.3, size=k.shape), jnp.float32),
                        "bias": params[name]["bias"]}
    ref = np.asarray(layer.apply({"params": params}, jnp.asarray(query), jnp.asarray(refs),
                                 jnp.asarray(feats), shapes, jnp.asarray(pad)))

    port = MSDeformAttn(C, L, M, P)
    state = {}
    for name in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
        state[f"{name}.weight"] = torch.from_numpy(np.asarray(params[name]["kernel"]).T.copy())
        state[f"{name}.bias"] = torch.from_numpy(np.asarray(params[name]["bias"]).copy())
    port.load_state_dict(state)
    with torch.no_grad():
        out = port(torch.from_numpy(query), torch.from_numpy(refs), torch.from_numpy(feats),
                   shapes, torch.from_numpy(pad)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_directional_offset_init_matches_jax():
    from uvhand_tpu.ops.msda import directional_offset_init as jax_init
    from uvhand_tpu_torch.ops.msda import directional_offset_init

    np.testing.assert_array_equal(directional_offset_init(8, 4, 4), jax_init(8, 4, 4))
