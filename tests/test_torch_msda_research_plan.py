"""The research kernels' kinds on the CPU: `msda_cuda.onlyg_plan` (which
`msda_onlyg` kernel takes which D, type and alignment), the onlyg and xdot
wrappers' routing and launch counts, and the ablation bench's tolerances
and bounds for them.

The kernels run only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py` phase 3d), so here the wrappers' launch is replaced by a stub
library that records which C entry was called with what; the input checks
that need CUDA tensors are replaced too. Tolerance: none (what is checked is
routing, counting and arithmetic on the bench's numbers), except where a
test names one.
"""

import types

import pytest
import torch

from uvhand_tpu_torch.ops import msda_cuda
from uvhand_tpu_torch.ops.msda_cuda import onlyg_plan
from uvhand_tpu_torch.scripts import bench_msda_ablation as bench

SHAPES = ((4, 4), (2, 2))  # S = 20, L = 2


@pytest.mark.parametrize("D,dtype,aligned,want", [
    # the tiled kernels: bf16 on the tensor cores, float32 on the CUDA cores
    (32, torch.bfloat16, True, "tiled"),
    (32, torch.float32, True, "tiled"),
    (16, torch.bfloat16, True, "tiled"),
    (16, torch.float32, True, "tiled"),
    # their tiles arrive by 16-byte cp.async: an unaligned value or g
    (32, torch.bfloat16, False, "general"),
    (16, torch.float32, False, "general"),
    # other D: the odd_d card case, rows under a bf16 k-step, wider heads
    (71, torch.float32, True, "general"),
    (8, torch.bfloat16, True, "general"),
    (24, torch.float32, True, "general"),
    (64, torch.bfloat16, True, "general"),
    (116, torch.float32, True, "general"),
    # other types the wrapper refuses before any plan
    (32, torch.float16, True, "general"),
    (32, torch.float64, True, "general"),
], ids=str)
def test_onlyg_plan_choices(D, dtype, aligned, want):
    assert onlyg_plan(D, dtype, aligned) == want


class StubLibrary:
    """The kernel library's research entries, recording each call (entry
    name, arguments) and accepting it."""

    def __init__(self):
        self.calls = []
        for kind in msda_cuda.ONLYG_KINDS:
            self._entry(f"msda_onlyg_{kind}")
        self._entry("msda_xdot")

    def _entry(self, name):
        setattr(self, name, lambda *args: self.calls.append((name, args)) or 0)


@pytest.fixture
def stub(monkeypatch):
    """A stub library, CPU tensors past the wrappers' card checks, and a
    stream of 0."""
    lib = StubLibrary()
    monkeypatch.setattr(msda_cuda, "library", lambda: lib)
    monkeypatch.setattr(msda_cuda, "_check", lambda *args, **kwargs: None)
    monkeypatch.setattr(msda_cuda, "_check_samples", lambda *args, **kwargs: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def onlyg_inputs(D, dtype, aligned=True, B=1, Lq=3, M=2, P=2):
    S = sum(h * w for h, w in SHAPES)
    n = B * S * M * D
    # a view one element into its storage starts 2 or 4 bytes past the boundary
    value = torch.zeros(n + 1, dtype=dtype)[0 if aligned else 1:][:n].view(B, S, M, D)
    loc = torch.zeros(B, Lq, M, len(SHAPES), P, 2)
    attn = torch.zeros(B, Lq, M, len(SHAPES), P, dtype=dtype)
    grad = torch.zeros(B, Lq, M * D, dtype=dtype)
    return value, SHAPES, loc, attn, grad


@pytest.mark.parametrize("kernel,D,dtype,aligned,want", [
    # kernel None: the public wrapper; else the bench's hook naming a kind
    (None, 32, torch.bfloat16, True, "tiled"),
    (None, 16, torch.float32, True, "tiled"),
    (None, 32, torch.float32, False, "general"),
    (None, 71, torch.float32, True, "general"),
    (None, 8, torch.bfloat16, True, "general"),
    ("general", 32, torch.bfloat16, True, "general"),
    ("tiled", 32, torch.float32, True, "tiled"),
], ids=str)
def test_onlyg_wrapper_launches_the_kind_the_plan_picks(stub, kernel, D, dtype, aligned, want):
    args = onlyg_inputs(D, dtype, aligned)
    counts = [msda_cuda.ONLYG_TILED, msda_cuda.ONLYG_GENERAL, msda_cuda.ms_deform_attn_onlyg_cuda]
    before = [c.launches for c in counts]
    dv, dpy, dpx, daw = (msda_cuda.ms_deform_attn_onlyg_cuda(*args) if kernel is None
                         else msda_cuda._launch_onlyg(kernel, *args))
    (entry, call_args), = stub.calls
    assert entry == f"msda_onlyg_{want}"
    B, S, M = args[0].shape[:3]
    # value, g, dv, dpy, dpx, daw (the entry zeroes dpy and dpx); then B, S,
    # Lq, M, D, L*P, is_bf16, device, stream
    assert call_args[:2] == (args[0].data_ptr(), args[4].data_ptr())
    assert call_args[2:6] == tuple(t.data_ptr() for t in (dv, dpy, dpx, daw))
    assert call_args[6:13] == (B, S, 3, M, D, 4, int(dtype == torch.bfloat16))
    assert dv.shape == (B, S, M, D) and dv.dtype == torch.float32
    for t in (dpy, dpx, daw):
        assert t.shape == args[2].shape[:5] and t.dtype == torch.float32
    delta = [c.launches - n for c, n in zip(counts, before)]
    assert delta == ([1, 0, 1] if want == "tiled" else [0, 1, 1])


@pytest.mark.parametrize("D,dtype,aligned", [(8, torch.bfloat16, True),
                                             (32, torch.float32, False)], ids=str)
def test_onlyg_wrapper_refuses_a_kind_that_does_not_apply(stub, D, dtype, aligned):
    args = onlyg_inputs(D, dtype, aligned)
    before = msda_cuda.ms_deform_attn_onlyg_cuda.launches
    with pytest.raises(ValueError, match="tiled onlyg kernel takes"):
        msda_cuda._launch_onlyg("tiled", *args)
    assert not stub.calls and msda_cuda.ms_deform_attn_onlyg_cuda.launches == before


def xdot_inputs(dtype, S_shapes=SHAPES, B=1, Lq=3, M=2, P=2):
    S = sum(h * w for h, w in S_shapes)
    G = torch.zeros(B * M, Lq, S, dtype=dtype)
    loc = torch.zeros(B, Lq, M, len(S_shapes), P, 2)
    attn = torch.zeros(B, Lq, M, len(S_shapes), P, dtype=dtype)
    return G, S_shapes, loc, attn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_xdot_wrapper_launches_its_kernel(stub, dtype):
    G, shapes, loc, attn = xdot_inputs(dtype)
    before = msda_cuda.ms_deform_attn_xdot_cuda.launches
    dpy, dpx, daw, ws = msda_cuda.ms_deform_attn_xdot_cuda(G, shapes, loc, attn)
    (entry, call_args), = stub.calls
    assert entry == "msda_xdot"
    # G, loc, attn, dpy, dpx, daw, ws, hw, level_start, then L, B, S, Lq, M, P, is_bf16
    assert call_args[:7] == tuple(t.data_ptr() for t in (G, loc, attn, dpy, dpx, daw, ws))
    assert list(call_args[7]) == [4, 4, 2, 2] and list(call_args[8]) == [0, 16]
    assert call_args[9:16] == (2, 1, 20, 3, 2, 2, int(dtype == torch.bfloat16))
    assert ws.shape == G.shape and ws.dtype == dtype
    assert msda_cuda.ms_deform_attn_xdot_cuda.launches == before + 1


def test_xdot_wrapper_takes_rows_past_the_general_kernels_limit(stub):
    """The kernel holds a window of a row at a time, so S past the 12288
    floats of the earlier (general) kernel's shared-memory row goes to it
    as any other."""
    G, shapes, loc, attn = xdot_inputs(torch.float32, ((111, 111),), P=1)
    msda_cuda.ms_deform_attn_xdot_cuda(G, shapes, loc, attn)
    (entry, call_args), = stub.calls
    assert entry == "msda_xdot" and call_args[11] == 111 * 111


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, bench.ONLYG_BF16_TOL),
                                        (torch.float32, 1e-5)], ids=str)
def test_bench_holds_onlyg_dvalue_to_its_tolerance(dtype, want):
    """onlyg's dvalue (float32 for either value type) within
    ONLYG_BF16_TOL of its max for a bf16 value (the tensor cores' G), 1e-5
    for float32; its other outputs exact."""
    outs = [torch.zeros(2)] * 4
    assert bench.tolerances("onlyg", outs, dtype) == {"dv": want}
    assert bench.tolerances("xdot", outs, dtype) == {"dv": bench.TOL[torch.float32]}
    ref = torch.tensor([1.0, 2.0])
    for off, ok in ((want, True), (4 * want, False)):  # rel want / 2, 2 want
        rows = bench.held(("dv", "daw"), (ref + torch.tensor([0.0, off]), torch.tensor([3.0])),
                          (ref, torch.tensor([3.0])), {"dv": want})
        assert [r[4] for r in rows] == [ok, True]
    rows = bench.held(("daw",), (torch.tensor([3.0 + 1e-6]),), (torch.tensor([3.0]),), {})
    assert not rows[0][4]  # no tolerance: exact


def test_kinds_ab_needs_the_card():
    with pytest.raises(RuntimeError, match="measures the card"):
        bench.kinds_ab(torch.float32, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_xdot_sector_estimate_is_not_under_the_bound(dtype):
    """G read in whole 32-byte sectors moves at least the bytes of the
    corners' elements, so the estimate is at or above the bound, and below
    reading the whole plane."""
    from uvhand_tpu_torch.ops import msda_ablation
    from uvhand_tpu_torch.scripts.measure import HBM_BYTES_PER_S

    x = bench.make_inputs(bench.CHECK_SHAPES, **bench.CHECK_DIMS, dtype=dtype, device="cpu",
                          seed=1, lo=-0.2, hi=1.2)
    G = msda_ablation.dense_plane(x["value"], x["g"])
    outs = msda_ablation.xdot_torch(G, x["shapes"], x["loc"], x["attn"])
    bound, by = bench.xdot_kernel_bound(x, G, outs)
    sector = bench.xdot_sector_ms(x, G, outs)
    whole = bound + G.numel() * G.element_size() / HBM_BYTES_PER_S * 1e3
    assert by == "bytes" and bound < sector < whole


@pytest.mark.parametrize("dtype,fails", [(torch.bfloat16, True), (torch.float32, False)],
                         ids=str)
def test_onlyg_bf16_tolerance_rejects_a_kernel_that_skips_the_rounding(dtype, fails):
    """At the bench's widths (one batch, two heads of the TPU shapes), a
    dvalue from a G kept in float32 is off by more than ONLYG_BF16_TOL of its
    max for a bf16 value; for float32 the rounding is none, and the control
    reads only the float32 sums' order (under 1e-5)."""
    from uvhand_tpu_torch.ops import msda_ablation

    x = bench.make_inputs(bench.BENCH_SHAPES, B=1, M=2, D=32, P=4, dtype=dtype, device="cpu",
                          seed=0, lo=0.0, hi=1.0)
    ref = msda_ablation.onlyg_torch(x["value"], x["shapes"], x["loc"], x["attn"], x["g"])[0]
    rel = bench.onlyg_unrounded_rel(x["value"], x["g"], ref)
    if fails:
        assert rel > bench.ONLYG_BF16_TOL
    else:
        assert rel < bench.TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_onlyg_bound_counts_only_what_the_kernel_moves(dtype):
    """onlyg reads the value and g and writes dvalue, dpy, dpx and daw; the
    locations and attention are not its bytes, so the bound does not move
    with them. The xdot variant reads them."""
    from uvhand_tpu_torch.scripts.measure import bound_ms, nbytes

    x = bench.make_inputs(bench.CHECK_SHAPES, **bench.CHECK_DIMS, dtype=dtype, device="cpu",
                          seed=0, lo=0.0, hi=1.0)
    outs = bench.run("onlyg", x, impl="torch")
    B, S, M, D = x["value"].shape
    ops = 4 * B * M * x["loc"].shape[1] * S * D
    rate = bench.BF16_TC_OPS_PER_S if dtype == torch.bfloat16 else bench.FP32_OPS_PER_S
    want = bound_ms(nbytes(x["value"], x["g"], *outs), ops, rate)
    assert bench.variant_bound("onlyg", x, outs) == want
    wider = dict(x, loc=torch.cat([x["loc"]] * 4, 0), attn=torch.cat([x["attn"]] * 4, 0))
    assert bench.variant_bound("onlyg", wider, outs) == want
    xdot_ms, _ = bench.variant_bound("xdot", x, outs)
    assert xdot_ms >= bound_ms(nbytes(x["value"], x["loc"], x["attn"], x["g"], *outs), 0)[0]
