"""The port's gather probes against the TPU probes' own references.

The TPU probes (`scripts/probe_dynamic_lane_slice.py`,
`scripts/repro_dynamic_gather.py`, `scripts/probe_gather_scale.py`) call
`pallas_call` with no `interpret=` argument, so their kernels cannot run on
the CPU. The port's plain versions (`uvhand_tpu_torch/ops/probes.py`, which
the CUDA kernels repeat and which the port runs for CPU tensors) are held
exactly, as the probes assert `err == 0`, against each probe's own numpy
reference (`probe_dynamic_lane_slice.py:54`, `repro_dynamic_gather.py:42`,
`probe_gather_scale.py:40`) at the probes' shapes. One cut: the largest,
(16, 1048, 1408), runs as 2 of its 16 blocks here.
"""

import numpy as np
import pytest
import torch

from uvhand_tpu_torch.ops import msda_cuda, probes
from uvhand_tpu_torch.scripts import bench_msda_ablation, probe_dynamic_lane_slice, probe_gather

# the probes' cases, the largest cut to 2 blocks
CASES = [(name, (2, 1048, 1408) if shape == (16, 1048, 1408) else shape, axis)
         for name, shape, axis in probe_gather.CASES]


def test_lane_slice_matches_the_probe_reference():
    M, Q, W = probe_dynamic_lane_slice.M, probe_dynamic_lane_slice.Q, probe_dynamic_lane_slice.W
    x = np.random.default_rng(0).standard_normal((Q, M * W)).astype(np.float32)
    out = probes.lane_slice_torch(torch.from_numpy(x), M, W).numpy()
    want = (x.reshape(Q, M, W).transpose(1, 0, 2).reshape(M * Q, W)) * 2.0
    assert out.shape == (M * Q, W) and np.array_equal(out, want)


@pytest.mark.parametrize("Q", [4 * 1048, 4 * 1048 + 3], ids=str)
def test_lane_slice_matches_the_probe_reference_at_the_call_site(Q):
    """The MSDA call site's per-head relayout (the probe's second case, Q =
    16 x 1048 at B = 16), cut to B = 4, and a Q that no tile divides."""
    M, W = probe_dynamic_lane_slice.M, probe_dynamic_lane_slice.W
    assert probe_dynamic_lane_slice.CASES[1][1] == 16 * 1048
    x = np.random.default_rng(1).standard_normal((Q, M * W)).astype(np.float32)
    out = probes.lane_slice_torch(torch.from_numpy(x), M, W).numpy()
    want = (x.reshape(Q, M, W).transpose(1, 0, 2).reshape(M * Q, W)) * 2.0
    assert out.shape == (M * Q, W) and np.array_equal(out, want)


@pytest.mark.parametrize("name,shape,axis", CASES, ids=lambda x: str(x))
def test_take_along_axis_matches_numpy(name, shape, axis):
    v, idx = probe_gather.case_arrays(shape, axis)
    out = probes.take_along_axis_torch(torch.from_numpy(v), torch.from_numpy(idx), axis)
    assert out.dtype == torch.float32
    assert np.array_equal(out.numpy(), np.take_along_axis(v, idx, axis))


def test_probe_entry_points_check_on_the_cpu(capsys):
    before = (msda_cuda.lane_slice_cuda.launches, msda_cuda.take_along_axis_cuda.launches)
    assert probe_dynamic_lane_slice.run("cpu")["max_abs_err"] == 0.0
    rows = probe_gather.run("cpu", cases=CASES)
    assert [r["max_abs_err"] for r in rows] == [0.0] * len(CASES)
    assert all(r["calls"] == 0 for r in rows)
    assert (msda_cuda.lane_slice_cuda.launches, msda_cuda.take_along_axis_cuda.launches) == before
    assert "max err 0" in capsys.readouterr().out


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bench_msda_ablation.main, probe_dynamic_lane_slice.main, probe_gather.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])


def test_probe_wrappers_take_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA tensors"):
        msda_cuda.lane_slice_cuda(torch.zeros(4, 32), 2, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        msda_cuda.take_along_axis_cuda(torch.zeros(4, 8), torch.zeros(4, 8, dtype=torch.int32), 1)
