"""The controls, on the card: the plain reference computed with TF32 on
(the precision below the configuration's float32 with TF32 off), put in the
program's place, must fail the cell's check. At full width on batches of
8 frames; the cells' own size is read by `python3 -m benchmark.calibrate
--control` on the chip (PERF.md gives those readings)."""

from __future__ import annotations

import copy
import shutil

import pytest
import torch

from benchmark import calibrate, check, run, spec


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sf_r50.train_b64", "sf_r50.eval_b64", "sf_swinl.train_b32"])
def test_tf32_reference_is_not_correct(cuda, name):
    cell = copy.deepcopy(spec.load_cell(name))
    cell.traffic.update(batch=8, batches=3)
    cell.traffic["root"].update(seqs=2, frames=6, views=2)
    run.set_precision(cell.config, cuda)
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        path = run.data_root()
        try:
            batches = run.make_traffic(cell, seed, path)
        finally:
            shutil.rmtree(path, ignore_errors=True)
        reference = calibrate.reference_side(cell, seed, cuda, batches)
        numbers = calibrate.control_numbers(cell, seed, cuda, batches, reference)
        correct, checks = check.judge(numbers, cell.limits)
        assert not correct, checks
        run.free(cuda)
