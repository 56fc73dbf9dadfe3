"""The gather probes' kernel kinds on the CPU: `msda_cuda.gather_plan` (the
staged or the general `probe_gather` kernel) and `msda_cuda.lane_slice_plan`
(the vec4 or the general `probe_lane_slice` kernel) for every case of both
probes and at their edges, the wrappers' routing and launch counts by kind,
and the probe scripts' bound and launch-floor arithmetic.

The kernels run only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py` phase 3d), so here the wrappers' launch is replaced by a stub
library that records which C entry was called with what; the input checks
that need CUDA tensors are replaced too. Tolerance: none (what is checked is
routing, counting and arithmetic), except the bounds, to 1e-12 relative.
"""

import types

import pytest
import torch

from uvhand_tpu_torch.ops import msda_cuda
from uvhand_tpu_torch.ops.msda_cuda import GatherPlan, gather_plan, lane_slice_plan
from uvhand_tpu_torch.scripts import probe_dynamic_lane_slice as lane_probe
from uvhand_tpu_torch.scripts import measure, probe_gather


def view(shape, axis):
    """The (N, R, C) view and its axis, as the wrapper forms them."""
    return (1,) * (3 - len(shape)) + tuple(shape), axis % len(shape) + (3 - len(shape))


@pytest.mark.parametrize("name,shape,axis,want", [
    # the probes' cases: rows of 24 KB stages, fewer rows where the chunks
    # would be under 2 an SM, a ring of 4 stages; each stage 8 more bytes.
    # Under 2 MiB of values (the first, third and last: 0.5-1.1 MB) the plan
    # picks the general kernel, though the staged one takes the shapes
    ("repro axis 0", (1408, 128), 0, GatherPlan("general")),
    ("repro axis 1", (1408, 128), 1, GatherPlan("general", 6, 4, 4 * (6 * 512 + 8))),
    ("scale", (8, 1048, 128), 2, GatherPlan("staged", 32, 4, 4 * (32 * 512 + 8))),
    ("scale", (1, 1048, 256), 2, GatherPlan("general", 4, 4, 4 * (4 * 1024 + 8))),
    ("scale", (1, 1048, 1408), 2, GatherPlan("staged", 4, 4, 4 * (4 * 5632 + 8))),
    ("scale", (16, 1048, 1408), 2, GatherPlan("staged", 4, 4, 90_144)),
    ("scale", (128, 8, 128), 2, GatherPlan("general", 4, 4, 4 * (4 * 512 + 8))),
], ids=str)
def test_gather_plan_for_every_probe_case(name, shape, axis, want):
    assert (name, shape, axis) in probe_gather.CASES
    assert gather_plan(*view(shape, axis)) == want
    # timed in turns: the plan's kernel first, then the other where the
    # staged kernel takes the case
    other = {"staged": "general", "general": "staged"}[want.kind]
    assert probe_gather.case_kinds(shape, axis) == (
        (want.kind, other) if want.stages else ("general",))


def test_gather_plan_picks_staged_from_two_mib_of_values():
    rows = (2 << 20) // (4 * 1408)  # 372 rows of 1408 floats: 2,095,104 bytes
    assert gather_plan((1, rows, 1408), 2).kind == "general"
    assert gather_plan((1, rows + 1, 1408), 2).kind == "staged"
    assert gather_plan((1, 4096, 128), 2).kind == "staged"  # exactly 2 MiB
    assert gather_plan((1, 4095, 128), 2).kind == "general"


@pytest.mark.parametrize("shape,axis,aligned,want", [
    # a view one float into its storage: every row start moves off 16 bytes
    ((16, 1048, 1408), 2, False, "general"),
    # rows that are not whole 16-byte vectors
    ((8, 1048, 130), 2, True, "general"),
    ((1, 3, 6), 2, True, "general"),
    # axis 1: a strip of all R rows, within shared memory or beyond it
    ((1, 1408, 128), 1, True, "general"),
    ((4, 60_000, 128), 1, True, "general"),
    # the ring's edge: two rows of 29,052 floats and their barriers fit
    # 232,448 bytes, rows of 29,056 do not
    ((1, 3, 29_052), 2, True, "staged"),
    ((1, 3, 29_056), 2, True, "general"),
], ids=str)
def test_gather_plan_edges(shape, axis, aligned, want):
    """Which kernel takes the shapes (`stages` set where the staged one
    does), whatever their size."""
    plan = gather_plan(shape, axis, aligned)
    assert ("staged" if plan.stages else "general") == want
    if want == "staged":
        assert plan.stages >= 2 and plan.smem <= msda_cuda.SMEM_LIMIT
        assert plan.smem == plan.stages * (plan.chunk_rows * shape[2] * 4 + 8)


def test_gather_plan_shrinks_the_ring_for_long_rows():
    # one row a stage; 4 stages up to 14,524 floats, then 3, then 2
    assert gather_plan((1, 9, 14_524), 2)[1:3] == (1, 4)
    assert gather_plan((1, 9, 14_528), 2)[1:3] == (1, 3)
    assert gather_plan((1, 9, 19_368), 2)[1:3] == (1, 3)
    assert gather_plan((1, 9, 19_372), 2)[1:3] == (1, 2)
    # fewer SMs, larger chunks (at most a stage's 24 KB)
    assert gather_plan((1, 1048, 256), 2, sms=16).chunk_rows == 24


@pytest.mark.parametrize("Q,M,W,aligned,want", [
    # the probe's shape and the MSDA call site's at B = 16
    (1048, 8, 16, True, "vec4"),
    (16 * 1048, 8, 16, True, "vec4"),
    # Q not a multiple of any tile: still whole vectors
    (1049, 8, 16, True, "vec4"),
    (7, 3, 4, True, "vec4"),
    # W % 4 != 0, a misaligned x, more vectors than an int32 holds
    (1048, 8, 6, True, "general"),
    (1048, 8, 18, True, "general"),
    (1048, 8, 16, False, "general"),
    (2 ** 28, 8, 4, True, "general"),
], ids=str)
def test_lane_slice_plan(Q, M, W, aligned, want):
    assert lane_slice_plan(Q, M, W, aligned) == want


class StubLibrary:
    """The kernel library's probe entries, recording each call (entry name,
    arguments) and accepting it."""

    def __init__(self):
        self.calls = []
        for name in ("probe_gather", "probe_gather_staged", "probe_lane_slice",
                     "probe_lane_slice_vec4", "probe_lane_slice_floor"):
            setattr(self, name, self._entry(name))

    def _entry(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def stub(monkeypatch):
    """A stub library, CPU tensors past the wrappers' card checks, a stream
    of 0 and a card of 132 SMs."""
    lib = StubLibrary()
    monkeypatch.setattr(msda_cuda, "library", lambda: lib)
    monkeypatch.setattr(msda_cuda, "_check_probe", lambda *args, **kwargs: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(multi_processor_count=132))
    return lib


def shifted(shape, dtype, offset):
    """A contiguous tensor of `shape` `offset` elements into its storage."""
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + 4, dtype=dtype)[offset:offset + n].view(shape)


def counts(kinds, wrapper):
    return [c.launches for c in kinds.values()] + [wrapper.launches]


@pytest.mark.parametrize("shape,axis,kind,offset,want,args", [
    # kind None: the public wrapper; else the probe's hook naming a kind
    ((1, 1048, 1408), 2, None, 0, "staged", (1, 1048, 1408, 4, 4, 90_144)),
    ((8, 1048, 128), -1, None, 0, "staged", (8, 1048, 128, 32, 4, 4 * (32 * 512 + 8))),
    ((1408, 128), -1, "staged", 0, "staged", (1, 1408, 128, 6, 4, 4 * (6 * 512 + 8))),
    ((1408, 128), -1, None, 0, "general", (1, 1408, 128, 2)),  # under 2 MiB
    ((1, 1048, 1408), 2, "general", 0, "general", (1, 1048, 1408, 2)),
    ((1408, 128), 0, None, 0, "general", (1, 1408, 128, 1)),
    ((3, 40, 1408), 1, None, 0, "general", (3, 40, 1408, 1)),
    ((2, 5, 130), 2, None, 0, "general", (2, 5, 130, 2)),
    ((2, 5, 128), 2, None, 1, "general", (2, 5, 128, 2)),  # misaligned v and idx
], ids=str)
def test_gather_wrapper_launches_the_kind_the_plan_picks(stub, shape, axis, kind, offset, want,
                                                        args):
    v, idx = shifted(shape, torch.float32, offset), shifted(shape, torch.int32, offset)
    before = counts(msda_cuda.GATHER_KINDS, msda_cuda.take_along_axis_cuda)
    out = (msda_cuda.take_along_axis_cuda(v, idx, axis) if kind is None
           else msda_cuda._launch_gather(kind, v, idx, axis))
    (entry, call_args), = stub.calls
    assert entry == ("probe_gather_staged" if want == "staged" else "probe_gather")
    # v, idx, out, N, R, C, then (staged) chunk_rows, stages, smem or
    # (general) the axis of the view, then the device and the stream
    assert call_args[:3] == (v.data_ptr(), idx.data_ptr(), out.data_ptr())
    assert call_args[3:-2] == args and call_args[-1] == 0
    assert out.shape == v.shape and out.dtype == torch.float32
    delta = [a - b for a, b in zip(counts(msda_cuda.GATHER_KINDS,
                                          msda_cuda.take_along_axis_cuda), before)]
    assert delta == ([1, 0, 1] if want == "staged" else [0, 1, 1])


@pytest.mark.parametrize("shape,axis,offset", [((2, 5, 128), 2, 1), ((2, 5, 130), 2, 0),
                                               ((1408, 128), 0, 0)], ids=str)
def test_gather_wrapper_refuses_a_staged_launch_that_does_not_apply(stub, shape, axis, offset):
    v, idx = shifted(shape, torch.float32, offset), shifted(shape, torch.int32, offset)
    before = counts(msda_cuda.GATHER_KINDS, msda_cuda.take_along_axis_cuda)
    with pytest.raises(ValueError, match="staged gather kernel takes"):
        msda_cuda._launch_gather("staged", v, idx, axis)
    assert not stub.calls
    assert counts(msda_cuda.GATHER_KINDS, msda_cuda.take_along_axis_cuda) == before


@pytest.mark.parametrize("Q,W,kind,offset,want", [
    (1048, 16, None, 0, "vec4"),
    (16 * 1048, 16, None, 0, "vec4"),
    (1048, 16, "general", 0, "general"),
    (1048, 6, None, 0, "general"),
    (1048, 16, None, 1, "general"),  # x one float into its storage
], ids=str)
def test_lane_slice_wrapper_launches_the_kind_the_plan_picks(stub, Q, W, kind, offset, want):
    M = 8
    x = shifted((Q, M * W), torch.float32, offset)
    before = counts(msda_cuda.LANE_SLICE_KINDS, msda_cuda.lane_slice_cuda)
    out = (msda_cuda.lane_slice_cuda(x, M, W) if kind is None
           else msda_cuda._launch_lane_slice(kind, x, M, W))
    (entry, call_args), = stub.calls
    assert entry == ("probe_lane_slice_vec4" if want == "vec4" else "probe_lane_slice")
    assert call_args == (x.data_ptr(), out.data_ptr(), Q, M, W, None, 0)
    assert out.shape == (M * Q, W) and out.dtype == torch.float32
    delta = [a - b for a, b in zip(counts(msda_cuda.LANE_SLICE_KINDS,
                                          msda_cuda.lane_slice_cuda), before)]
    assert delta == ([1, 0, 1] if want == "vec4" else [0, 1, 1])


def test_lane_slice_floor_launches_the_empty_kernel_and_counts_nothing(stub):
    x = torch.zeros(1048, 128)
    before = counts(msda_cuda.LANE_SLICE_KINDS, msda_cuda.lane_slice_cuda)
    out = msda_cuda.lane_slice_floor_cuda(x, 8, 16)
    assert stub.calls == [("probe_lane_slice_floor", (x.data_ptr(), out.data_ptr(), 1048, 8, 16,
                                                      None, 0))]
    assert counts(msda_cuda.LANE_SLICE_KINDS, msda_cuda.lane_slice_cuda) == before
    with pytest.raises(ValueError, match="launch floor"):
        msda_cuda.lane_slice_floor_cuda(torch.zeros(1048, 48), 8, 6)
    with pytest.raises(ValueError, match="vec4 lane-slice kernel takes"):
        msda_cuda._launch_lane_slice("vec4", torch.zeros(1048, 48), 8, 6)
    assert len(stub.calls) == 1


@pytest.mark.parametrize("Q,want_us", [(1048, 0.3203438805970149),
                                       (16 * 1048, 5.125502089552239)], ids=str)
def test_lane_slice_bound(Q, want_us):
    # x read once, out written once: 2 * Q * 8 * 16 floats over 3.35 TB/s
    ms, by = lane_probe.lane_bound(Q)
    assert by == "bytes" and ms * 1e3 == pytest.approx(want_us, rel=1e-12)
    assert ms * 1e3 == pytest.approx(2 * Q * 128 * 4 / 3.35e12 * 1e6, rel=1e-12)


def test_lane_slice_reading_beside_bound_and_floor():
    bound = lane_probe.lane_bound(16 * 1048)[0]
    # half the bound's rate: twice the bound, 50 %; 2 us over a 3 us floor
    assert lane_probe.judge(2 * bound, bound, 0.003) == (
        f"50.0% of the byte bound, {(2 * bound - 0.003) * 1e3:+.2f} us over the launch floor")
    # under the bound: served from L2, never a share of it
    text = lane_probe.judge(0.5 * bound, bound, 0.001)
    assert text.startswith("under the byte bound: L2 served it") and "%" not in text
    assert lane_probe.judge(None, bound, 0.001) == "not measured"
    assert lane_probe.judge(bound, bound, None) == "100.0% of the byte bound"


def test_gather_bound_and_turns():
    # 12 bytes an element: index and value read, value written
    ms, by = probe_gather.case_bound((16, 1048, 1408))
    assert by == "bytes" and ms == pytest.approx(16 * 1048 * 1408 * 12 / 3.35e12 * 1e3,
                                                 rel=1e-12)
    assert round(ms, 5) == 0.08457
    assert probe_gather.turns(("staged", "general")) == ("staged", "general", "general",
                                                         "staged")
    assert probe_gather.turns(("general",)) == ("general",)
    assert measure.lower([None, 0.2, 0.1]) == 0.1 and measure.lower([None]) is None
    assert lane_probe.CASES == (("probe", 1048), ("call site B=16", 16 * 1048))
    assert lane_probe.KINDS == ("vec4", "general")
