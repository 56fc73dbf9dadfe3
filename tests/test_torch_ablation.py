"""The port's MSDA backward ablation against the JAX package's TPU bench.

The TPU bench `scripts/bench_msda_ablation.py` builds each variant with
`build(variant, ...)`; its kernels run here in interpret mode, at the
script's own check shapes (`:1252-1256`: levels 6x6, 3x3, 2x2; B=2, M=2,
D=32, P=4, Lq=S=49; inputs from numpy seed 1). The port's plain versions
(`uvhand_tpu_torch/ops/msda_ablation.py` and the landed
`uvhand_tpu_torch/ops/msda.py` ones, which the CUDA kernels repeat and which
the port runs for CPU tensors) take the same numbers, and the TPU outputs
are brought from Mosaic's padded layout (every level padded to 128 tokens,
queries to the tile) to the op's (`_level_plan`).

Tolerances, relative to each output's max: float32 1e-5 (sums in another
order); bfloat16 2e-2 (the TPU kernel rounds its weight plane to bf16 before
the dvalue product, which the gather form never builds). The `xdot`
variant's TPU kernel takes no `interpret=` argument and cannot run on the
CPU, so the port's `xdot` is held against the TPU `full` (the same function
in float32). Every JAX output is computed once per module.
"""

import functools
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvhand_tpu.ops import msda_pallas as mp
from uvhand_tpu_torch.ops import msda_ablation, msda_cuda
from uvhand_tpu_torch.ops.msda import (ms_deform_attn_fac_torch,
                                       ms_deform_attn_fac_torch_backward, ms_deform_attn_torch,
                                       ms_deform_attn_torch_backward)
from uvhand_tpu_torch.scripts import bench_msda_ablation as bench

ROOT = pathlib.Path(__file__).resolve().parents[1]
TPU_SCRIPT = ROOT / "scripts" / "bench_msda_ablation.py"
_spec = importlib.util.spec_from_file_location("tpu_bench_msda_ablation", TPU_SCRIPT)
tpu_bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tpu_bench)

B, M, D, P = 2, 2, 32, 4
CASES = {
    "check": ((6, 6), (3, 3), (2, 2)),  # the TPU script's check shapes
    # every sample on an exact pixel centre: sides that are powers of two make
    # (cell + 0.5) / size exact in float32
    "integer": ((8, 8), (4, 4), (2, 2)),
}
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
GRADS = ("dv", "dpy", "dpx", "daw")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several processes on the CPU at once: torch's default
    of one thread per core oversubscribes it (as `test_torch_train.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def inputs(case):
    """(value, loc, attn, g) as numpy float32, drawn as the TPU check draws them."""
    shapes = CASES[case]
    S = sum(h * w for h, w in shapes)
    L, Lq = len(shapes), S
    rng = np.random.default_rng(1)
    value = rng.standard_normal((B, S, M, D)).astype(np.float32)
    if case == "integer":
        size = np.array([[w, h] for h, w in shapes], np.float32)
        u = rng.uniform(0, 1, (B, Lq, M, L, P, 2))
        loc = ((np.floor(u * size[:, None, :]) + 0.5) / size[:, None, :]).astype(np.float32)
    else:
        loc = rng.uniform(-0.2, 1.2, (B, Lq, M, L, P, 2)).astype(np.float32)
    attn = rng.uniform(0, 1, (B, Lq, M, L, P)).astype(np.float32)
    g = rng.standard_normal((B, Lq, M * D)).astype(np.float32)
    return value, loc, attn, g


def torch_inputs(case, dtype):
    """The inputs as the port takes them, in `dtype` (the locations float32)."""
    value, loc, attn, g = inputs(case)
    tdt = DTYPES[dtype][1]
    return (torch.from_numpy(value).to(tdt), CASES[case], torch.from_numpy(loc),
            torch.from_numpy(attn).to(tdt), torch.from_numpy(g).to(tdt))


@functools.lru_cache(maxsize=None)
def jax_outputs(variant, dtype, case):
    """The TPU variant's outputs in the op's layouts, float32 numpy: (dv
    (B, S, M, D), dpy, dpx, daw (B, Lq, M, L, P)) or, for a forward, (out
    (B, Lq, M*D),)."""
    shapes = CASES[case]
    value, loc, attn, g = inputs(case)
    jdt = DTYPES[dtype][0]
    S, L = value.shape[1], len(shapes)
    Lq = S
    pyb, pxb, awb, vp = mp._layouts(shapes, jnp.asarray(value, jdt), jnp.asarray(loc),
                                    jnp.asarray(attn, jdt))
    gb = jnp.transpose(jnp.asarray(g, jdt).reshape(B, Lq, M, D), (0, 2, 1, 3))
    gb = jnp.pad(gb.reshape(B * M, Lq, D), ((0, 0), (0, pyb.shape[1] - Lq), (0, 0)))
    outs = tpu_bench.build(variant, shapes, (B, S, M, D, Lq, P), vp.dtype)(pyb, pxb, awb, vp, gb)
    outs = [np.asarray(jnp.asarray(o, jnp.float32)) for o in outs]
    if variant.startswith("fwd"):
        out = outs[0][:, :Lq].reshape(B, M, Lq, D).transpose(0, 2, 1, 3)
        return (out.reshape(B, Lq, M * D),)
    sizes, _, offs, _ = mp._level_plan(shapes)
    dv = np.concatenate([outs[0][:, o:o + n] for n, o in zip(sizes, offs)], axis=1)
    dv = dv.reshape(B, M, S, D).transpose(0, 2, 1, 3)
    per_point = [x[:, :Lq].reshape(B, M, Lq, L, P).transpose(0, 2, 1, 3, 4) for x in outs[1:]]
    return (dv, *per_point)


def assert_close(name, ours, ref, tol):
    ours = ours.float().numpy() if isinstance(ours, torch.Tensor) else ours
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max())
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert err <= tol * scale, f"{name}: max|delta| {err:.3e} > {tol:.0e} of max {scale:.3e}"


def port_variant(variant, dtype, case):
    """The port's plain version of a gather-form variant -> (dv, dpy, dpx, daw)."""
    route, opts = bench.VARIANTS[variant]
    args = torch_inputs(case, dtype)
    if route == "onlyg":
        return msda_ablation.onlyg_torch(*args)
    if route == "xdot":
        return msda_ablation.xdot_backward(*args, impl="torch")
    return msda_ablation.ablate_backward_torch(*args, **opts)


# S1a-c and S1d: every variant of the TPU kernel `kernel` (:1064)
GATHER_VARIANTS = ["full", "matred", "signfree", "fused", "eqgate", "eqred", "nodpy", "nodaw",
                   "nodv", "onlyg"]


@pytest.mark.parametrize("variant", GATHER_VARIANTS)
def test_variant_matches_tpu_kernel_fp32(variant):
    ref = jax_outputs(variant, "float32", "check")
    for name, ours, r in zip(GRADS, port_variant(variant, "float32", "check"), ref):
        assert ours.dtype == torch.float32
        assert_close(f"{variant}.{name}", ours, r, 1e-5)


@pytest.mark.parametrize("variant", ["full", "onlyg"])
def test_variant_matches_tpu_kernel_bf16(variant):
    ref = jax_outputs(variant, "bfloat16", "check")
    for name, ours, r in zip(GRADS, port_variant(variant, "bfloat16", "check"), ref):
        assert_close(f"{variant}.{name}", ours, r, 2e-2)


@pytest.mark.parametrize("variant", ["full", "eqgate"])
def test_integer_exact_gates_match_tpu_kernel(variant):
    """At integer-exact coordinates the where-gate gives a kink's far corner
    sign(0) = 0 and the equality gate a one-sided slope; the port repeats
    each."""
    ref = jax_outputs(variant, "float32", "integer")
    for name, ours, r in zip(GRADS, port_variant(variant, "float32", "integer"), ref):
        assert_close(f"{variant}.{name}", ours, r, 1e-5)


def test_integer_exact_gates_differ():
    full = port_variant("full", "float32", "integer")
    eq = port_variant("eqgate", "float32", "integer")
    for k, name in enumerate(GRADS):
        same = torch.equal(full[k], eq[k])
        assert same == (name in ("dv", "daw")), name
    # and off the kinks the two gates are one function
    full_c, eq_c = (port_variant(v, "float32", "check") for v in ("full", "eqgate"))
    assert all(torch.equal(a, b) for a, b in zip(full_c, eq_c))


# S1f-i: the design variants, held against the landed kernels' plain versions
@pytest.mark.parametrize("variant", ["sep", "sepx", "sep2", "sepT", "bwdfac"])
def test_backward_design_variant_matches_landed_plain_version(variant):
    value, shapes, loc, attn, g = torch_inputs("check", "float32")
    plain = (ms_deform_attn_fac_torch_backward if variant == "bwdfac"
             else ms_deform_attn_torch_backward)
    dvalue, dloc, dattn = plain(value, shapes, loc, attn, g)
    dv, dpy, dpx, daw = jax_outputs(variant, "float32", "check")
    Ws = np.array([w for _, w in shapes], np.float32)[:, None]
    Hs = np.array([h for h, _ in shapes], np.float32)[:, None]
    assert_close(f"{variant}.dvalue", dvalue, dv, 1e-5)
    assert_close(f"{variant}.dloc x", dloc[..., 0], dpx * Ws, 1e-5)
    assert_close(f"{variant}.dloc y", dloc[..., 1], dpy * Hs, 1e-5)
    assert_close(f"{variant}.dattn", dattn, daw, 1e-5)


@pytest.mark.parametrize("variant", ["fwd", "fwdsepx", "fwdT", "fwdfac"])
def test_forward_design_variant_matches_landed_plain_version(variant):
    value, shapes, loc, attn, _ = torch_inputs("check", "float32")
    plain = ms_deform_attn_fac_torch if variant == "fwdfac" else ms_deform_attn_torch
    (ref,) = jax_outputs(variant, "float32", "check")
    assert_close(variant, plain(value, shapes, loc, attn), ref, 1e-5)


@pytest.mark.parametrize("variant", ["xdot", "xdotred"])
def test_xdot_matches_tpu_full(variant):
    ref = jax_outputs("full", "float32", "check")
    for name, ours, r in zip(GRADS, port_variant(variant, "float32", "check"), ref):
        assert_close(f"{variant}.{name}", ours, r, 1e-5)


def test_xdot_weight_plane_is_the_dense_tent_sum():
    """ws[bm, q, s] = sum over the row's points of a * tent at s: the dense
    plane the TPU kernel writes, rebuilt here from the TPU's own grid maps."""
    value, shapes, loc, attn, g = torch_inputs("check", "float32")
    G = msda_ablation.dense_plane(value, g)
    ws = msda_ablation.xdot_torch(G, shapes, loc, attn)[3].numpy()
    sizes, _, offs, _ = mp._level_plan(shapes)
    sy, sx = (np.concatenate([m[0, o:o + n] for n, o in zip(sizes, offs)])
              for m in mp._grid_maps(shapes))
    lvl = np.concatenate([np.full(n, i) for i, n in enumerate(sizes)])
    Hs = np.array([h for h, _ in shapes], np.float32)[lvl]
    Ws = np.array([w for _, w in shapes], np.float32)[lvl]
    loc_n, attn_n = loc.numpy(), attn.numpy()
    want = np.zeros_like(ws)
    for p in range(P):
        px = loc_n[:, :, :, lvl, p, 0] * Ws - 0.5  # (B, Lq, M, S)
        py = loc_n[:, :, :, lvl, p, 1] * Hs - 0.5
        hat = np.maximum(1 - np.abs(py - sy), 0) * np.maximum(1 - np.abs(px - sx), 0)
        term = attn_n[:, :, :, lvl, p] * hat
        want += term.transpose(0, 2, 1, 3).reshape(ws.shape)
    assert_close("ws", ws, want, 1e-6)


def test_onlyg_reads_daw_off_level_zero():
    value, shapes, loc, attn, g = torch_inputs("check", "float32")
    with pytest.raises(ValueError, match="level 0"):
        msda_ablation.onlyg_torch(value[:, :16 + 4], ((2, 2), (4, 4)), loc[:, :, :, :2],
                                  attn[:, :, :, :2], g)


def test_dispatch_runs_plain_versions_on_the_cpu():
    args = torch_inputs("check", "float32")
    counters = (msda_cuda.ms_deform_attn_ablate_backward_cuda, msda_cuda.ms_deform_attn_onlyg_cuda,
                msda_cuda.ms_deform_attn_xdot_cuda)
    before = [c.launches for c in counters]
    pairs = [(msda_ablation.ablate_backward(*args, out="nodaw"),
              msda_ablation.ablate_backward_torch(*args, out="nodaw")),
             (msda_ablation.onlyg(*args), msda_ablation.onlyg_torch(*args))]
    G = msda_ablation.dense_plane(args[0], args[4])
    pairs.append((msda_ablation.xdot(G, *args[1:4]), msda_ablation.xdot_torch(G, *args[1:4])))
    for got, want in pairs:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="unknown impl"):
        msda_ablation.onlyg(*args, impl="pallas")


def test_wrappers_take_cuda_tensors_only():
    value, shapes, loc, attn, g = torch_inputs("check", "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        msda_cuda.ms_deform_attn_ablate_backward_cuda(value, shapes, loc, attn, g)
    with pytest.raises(ValueError, match="CUDA tensors"):
        msda_cuda.ms_deform_attn_onlyg_cuda(value, shapes, loc, attn, g)
    with pytest.raises(ValueError, match="CUDA tensors"):
        msda_cuda.ms_deform_attn_xdot_cuda(msda_ablation.dense_plane(value, g), shapes, loc, attn)


def test_harness_takes_every_variant_of_the_tpu_script():
    text = TPU_SCRIPT.read_text()
    names = set(re.findall(r'variant (?:==|!=) "(\w+)"', text))
    for group in re.findall(r"variant in \(([^)]*)\)", text):
        names |= set(re.findall(r'"(\w+)"', group))
    names |= set(re.findall(r'"(\w+)"', text[text.index("variants = args or"):]
                             .split("]")[0]))
    assert len(names) == 21 and names == set(bench.VARIANTS), sorted(names ^ set(bench.VARIANTS))
    assert set(bench.REPLACES) == set(bench.VARIANTS)


def test_harness_check_runs_on_the_cpu(capsys):
    """One variant of each route through --check: on the CPU every route is
    its plain version."""
    one_per_route = {route: v for v, (route, _) in reversed(bench.VARIANTS.items())}
    rows, calls = bench.check(sorted(one_per_route.values()), device="cpu", log=print)
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in rows) and not +calls
    assert len(rows) == sum(len(bench.ROUTES[r][2]) for r in one_per_route)
    bench.main(["--device", "cpu", "--check", "fwd"])  # in float32, then in bf16
    assert capsys.readouterr().out.count("ok\n") == len(rows) + 2
    with pytest.raises(RuntimeError, match="measures the card"):
        bench.bench(["full"], device="cpu")
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--check", "nosuchvariant"])
