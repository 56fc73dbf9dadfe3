"""The plain reference against the port's CPU path at a small width, the
weights both sides load, and the yardstick's numbers, each through the
configuration's family."""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import check, roofline, run, spec, weights
from benchmark.tests import tiny_cells

CPU = torch.device("cpu")
CONFIGS = ("arctic_sf_r50", "arctic_sf_swinl")


def config(name):
    return json.load(open(os.path.join(spec.ROOT, "benchmark", "configs", f"{name}.json")))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return {loop: tiny_cells.make(tmp_path_factory.mktemp(loop), loop)
            for loop in ("train", "eval")}


@pytest.mark.parametrize("seed", [5, 6])
def test_train_steps_agree_with_the_port(roots, seed):
    """Step 1 runs the same operations on the same inputs and dropout draws:
    its loss and its gradient are equal to rounding (the port's criterion
    folds the decoder layers into one batch, so its MANO products and its
    weighted sum round apart from the reference's loop: under half the
    cell's 2e-6); the port's gradient is read back from AdamW's state."""
    _, numbers, _ = run.run_cell(tiny_cells.args("train", seed=seed), CPU, root=roots["train"])
    assert numbers["loss_gap.1"] < 1e-6
    assert numbers["grad_gap"] < 1e-5
    assert numbers["update_gap.1"] < 1e-4
    assert numbers["update_gap.median"] < 1e-3
    assert numbers["data_gap.gt"] == 0.0


def test_eval_rows_equal_the_port(roots):
    _, numbers, _ = run.run_cell(tiny_cells.args("eval"), CPU, root=roots["eval"])
    assert set(numbers) == {f"row_gap.{m}" for m in (
        "aae", "mpjpe/ra/h", "mrrpe/r/l", "mrrpe/r/o", "success_rate/0.05", "cdev/ho")} | {
        "data_gap.gt", "data_gap.kp2d", "data_gap.image"}
    assert all(v == 0.0 for v in numbers.values()), numbers


@pytest.mark.parametrize("loop,key,row", [("train", "object.radian", 0),
                                          ("train", "mano.pose.l", 5),
                                          ("train", "intrinsics", 2),
                                          ("eval", "mano.beta.l", 1),
                                          ("eval", "object.kp2d.norm.b", 3),
                                          ("eval", "images", 7)])
def test_the_data_check_sees_one_altered_field(roots, tmp_path, loop, key, row):
    """The set-up's batches equal the plain reading of the root, field for
    field; one element of one row moved reads on its group's number."""
    cell = spec.load_cell(f"tiny.{loop}", roots[loop])
    c, t = cell.config, cell.traffic
    batches = run.make_traffic(cell, 2 ** 31 + 21, str(tmp_path))
    sound = check.data_numbers(batches, str(tmp_path), t["split"], c["img_res"], 1)
    assert all(v == 0.0 for v in sound.values()), sound
    b = batches[row // t["batch"]]
    b[key] = b[key].copy()
    b[key].reshape(t["batch"], -1)[row % t["batch"], -1] += 0.01
    if key == "images":  # the check reads every image of a batch this small
        assert check.IMAGE_ROWS >= t["batch"] * t["batches"]
    moved = check.data_numbers(batches, str(tmp_path), t["split"], c["img_res"], 1)
    assert max(moved.values()) >= 0.01 - 1e-6, moved


@pytest.mark.parametrize("name", CONFIGS)
def test_both_sides_have_the_same_parameters(name):
    c = config(name)
    family = spec.family(c)
    with torch.device("meta"):
        port = family.port_model(c, "meta")
    ref = family.flops_model(c, "meta")
    assert dict(weights.shapes(port)) == dict(weights.shapes(ref))


def test_the_weights_are_the_seeds():
    c = config("arctic_sf_r50")
    shapes = [("a.weight", (4, 3)), ("b.norm1.weight", (3,)), ("b.bias", (3,)),
              ("transformer.two_stage_learn_xy.weight", (1, 40))]
    one = weights.draw(shapes, c, 2 ** 31 + 3, CPU)
    two = weights.draw(list(reversed(shapes)), c, 2 ** 31 + 3, CPU)
    other = weights.draw(shapes, c, 2 ** 31 + 4, CPU)
    assert all(torch.equal(one[n], two[n]) for n in one)
    assert not torch.equal(one["a.weight"], other["a.weight"])
    assert torch.equal(one["b.norm1.weight"], torch.ones(3))
    assert torch.equal(one["b.bias"], torch.zeros(3))


def test_msda_bounds_are_the_kernel_tables():
    """PERF.md's K1 row: at B = 16, fp32, one encoder call 0.0179 ms, one
    decoder call 0.0088 ms, a batch's 12 calls 0.160 ms (bytes)."""
    c = config("arctic_sf_r50")
    m = c["model"]
    shapes = roofline.spatial_shapes(c)
    assert shapes == [(28, 28), (14, 14), (7, 7), (4, 4)]
    enc = roofline.msda_call_bound_s(16, 1045, shapes, 8, 32, 4, "float32", False) * 1e3
    dec = roofline.msda_call_bound_s(16, m["num_queries"], shapes, 8, 32, 4, "float32",
                                     False) * 1e3
    assert round(enc, 4) == 0.0179 and round(dec, 4) == 0.0088
    assert round(roofline.msda_bound_s(c, 16, "eval", spec.family(c)) * 1e3, 3) == 0.160
    bwd = roofline.msda_call_bound_s(16, 1045, shapes, 8, 32, 4, "float32", True) * 1e3
    assert round(bwd, 4) == 0.0307  # the K3 row's encoder call


#: the MSDA bounds (s) of a step and an eval batch at the cells' batches,
#: and the operations of one frame, that `msda_roofline.*` and
#: `flops_per_frame` rest on: held to the bit, so that no reading moves unseen
MSDA_COUNTS = {
    ("arctic_sf_r50", 64, "train"): (0.0017621358805970152, 871818240.0),
    ("arctic_sf_r50", 64, "eval"): (0.0006400030567164179, 289228800.0),
    ("arctic_sf_swinl", 32, "train"): (0.0008810679402985076, 871818240.0),
    ("arctic_sf_swinl", 32, "eval"): (0.00032000152835820895, 289228800.0),
}


@pytest.mark.parametrize("name,batch,loop", sorted(MSDA_COUNTS))
def test_msda_counts_are_the_family_s_to_the_bit(name, batch, loop):
    c = config(name)
    bound, ops = MSDA_COUNTS[name, batch, loop]
    assert roofline.msda_bound_s(c, batch, loop, spec.family(c)) == bound
    assert roofline.msda_flops(c, 1, loop, spec.family(c)) == ops


@pytest.mark.parametrize("name", CONFIGS)
def test_the_stored_flops_are_recounted(name):
    c = config(name)
    assert "family" not in c  # arctic_sf, the default
    assert spec.family(c).__name__ == "benchmark_family_arctic_sf"
    assert roofline.count_flops(c, spec.family(c)) == pytest.approx(c["flops_per_frame"],
                                                                     rel=1e-9)
