"""The harness on the CPU: a cell added by files alone runs, and so does a
configuration of a model family added by files alone; the result line's
keys, the refusal without a card, the window's rate and the p95, and the
planted faults that the check must catch."""

from __future__ import annotations

import json
import os
import textwrap

import numpy as np
import pytest
import torch

from benchmark import readers, roofline, run, spec, trace
from benchmark.tests import tiny_cells

CPU = torch.device("cpu")
E2E = {"train": ["setup_s", "train_frames_per_s"],
       "eval": ["eval_batch_ms_p95", "eval_frames_per_s", "setup_s"]}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return {loop: tiny_cells.make(tmp_path_factory.mktemp(loop), loop) for loop in E2E}


@pytest.mark.parametrize("loop", sorted(E2E))
def test_a_cell_added_by_files_runs(roots, loop):
    result, numbers, _ = run.run_cell(tiny_cells.args(loop), CPU, root=roots[loop])
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device",
                            "kernels_built", "checks"]
    assert result["correct"], result["checks"]
    assert sorted(result["metrics"]) == E2E[loop]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == set(spec.load_cell(f"tiny.{loop}", roots[loop]).limits)
    json.dumps(result, allow_nan=False)


@pytest.mark.parametrize("loop", sorted(E2E))
def test_traced_line_has_the_breakdown_and_the_per_layer_metrics(roots, loop):
    result, _, readings = run.run_cell(tiny_cells.args(loop, trace=1), CPU, root=roots[loop])
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                            "kernels_built", "checks"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    cell = spec.load_cell(f"tiny.{loop}", roots[loop])
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    if loop == "train":  # the engine's ranges are on the host: the CPU profile has them
        assert {f"stage_ms.{s}.train" for s in ("forward", "criterion", "backward")} \
            <= set(result["metrics"])


@pytest.mark.parametrize("loop,fault", [("train", "frozen_state"), ("train", "half_batch"),
                                        ("train", "altered_answer"), ("train", "group_rate"),
                                        ("eval", "half_batch"), ("eval", "altered_answer"),
                                        ("eval", "shifted_images")])
def test_a_fault_under_the_timed_path_is_not_correct(roots, loop, fault):
    result, _, _ = run.run_cell(tiny_cells.args(loop), CPU, root=roots[loop], fault=fault)
    assert result["correct"] is False, result["checks"]


#: a family written into a copy of the benchmark: arctic_sf under another
#: name, with MSDA calls of its own
WRAPPED = textwrap.dedent("""
    from benchmark.families.arctic_sf import (check_batches, data_numbers, flops_model,
                                              make_batches, port, reference_eval,
                                              reference_train)


    def msda_calls(config, batch, loop):
        return [(3, 11, 2, False)] + ([(3, 11, 2, True)] if loop == "train" else [])
""")


@pytest.mark.parametrize("loop", sorted(E2E))
def test_a_family_added_by_files_runs(tmp_path, loop):
    """The configuration names the family; the run takes its model, steps
    and reference from that module, and `msda_roofline` its calls."""
    root = tiny_cells.make(tmp_path, loop, family="wrapped")
    with open(os.path.join(root, "benchmark", "families", "wrapped.py"), "w") as f:
        f.write(WRAPPED)
    result, _, readings = run.run_cell(tiny_cells.args(loop, family="wrapped"), CPU, root=root)
    assert result["correct"], result["checks"]
    assert sorted(result["metrics"]) == E2E[loop]
    family = spec.load_cell(f"tiny_wrapped.{loop}", root).family
    assert readings.family is family
    assert os.path.dirname(family.__file__) == os.path.join(root, "benchmark", "families")

    # the CPU trace has no MSDA kernels: one traced step with 2 ms of them
    readings.trace = trace.Trace(steps=1, window_s=1.0, busy_s=0.5,
                                 kernels={"msda_fwd_staged_kernel": (1, 0.002)})
    c, b = readings.config, readings.batch
    read = spec.reader(f"msda_roofline.{loop}", root)(readings)
    own = 100.0 * roofline.msda_bound_s(c, b, loop, family) / 0.002
    arctic = 100.0 * roofline.msda_bound_s(c, b, loop, spec.family({})) / 0.002
    assert read == own and own != arctic
    assert family.msda_calls(c, b, loop) != spec.family({}).msda_calls(c, b, loop)


def test_an_unknown_family_is_refused_by_name(tmp_path):
    root = tiny_cells.make(tmp_path, "eval", family="no_such_family")
    with pytest.raises(ValueError, match=r"no_such_family.*'arctic_sf'"):
        spec.load_cell("tiny_no_such_family.eval", root)
    with pytest.raises(ValueError, match="arctic_sf"):
        spec.family({"family": "no_such_family"})


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "sf_r50.train_b64", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_the_rate_is_all_frames_over_all_seconds():
    r = run.Readings("train", 64, {}, setup_s=1.0, window_s=2.5, steps=7)
    assert readers.rate(r, "train") == 7 * 64 / 2.5
    assert readers.rate(r, "eval") is None


def test_the_p95_is_over_every_batch():
    ms = list(np.linspace(50.0, 60.0, 190)) + [500.0] * 10  # the tail is 5 % of the batches
    r = run.Readings("eval", 64, {}, setup_s=1.0, window_s=10.0, steps=200,
                     timing={"batch_ms": ms})
    value = spec.reader("eval_batch_ms_p95")(r)
    assert value == pytest.approx(np.percentile(ms, 95))
    assert value > 60.0
