"""The port's span recorder (`utils/spans.py`), the spans the engine's loops
record, and the benchmark's readers of them, on the CPU.

The loops run the tiny model of `test_torch_train.py` (1 + 2 layers, d=64,
12 queries) on batches of 2 frames at 64x64 from the port's own synthetic
root, two steps or batches each.
"""

import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run, spec
from uvhand_tpu_torch import engine
from uvhand_tpu_torch.data import arctic
from uvhand_tpu_torch.geometry import mano, objects
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.train.state import create_optimizer
from uvhand_tpu_torch.utils.spans import recording, span, steps

RES = 64
CFG = dict(num_queries=12, num_encoder_layers=1, num_decoder_layers=2, d_model=64,
           n_heads=4, dim_feedforward=128)
#: the children of a train step and of an eval batch, in order
TRAIN_CHILDREN = ["targets", "forward", "criterion", "backward", "clip+optimizer", "read"]
EVAL_CHILDREN = ["targets", "forward", "decode", "metrics", "read"]
#: the two-stage criterion: the layers' matching, their losses, the interm matching
CRITERION_CHILDREN = ["match", "layer_losses", "match"]
#: the readers this file's spans feed: metric -> (loop, span)
READERS = {**{f"host_ms.{m}.train": ("train", s) for m, s in (
    ("targets", "targets"), ("forward", "forward"), ("criterion", "criterion"),
    ("match", "match"), ("layer_losses", "layer_losses"), ("backward", "backward"),
    ("optimizer", "clip+optimizer"), ("read", "read"))},
    "wait_ms.eval": ("eval", "wait"),
    **{f"host_ms.{s}.eval": ("eval", s) for s in ("targets", "forward", "decode", "metrics",
                                                   "read")}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("arctic"))
    bank = objects.synthetic_object_bank(2, device="cpu")
    arctic.make_synthetic_root(root, num_seqs=1, frames=4, views=1, obj_bank=bank)
    ds = arctic.ArcticDataset(root, "p1", "train", aug=False, kp3d_cano=bank.kp_bottom.numpy(),
                              img_res=RES)
    batches = [arctic.collate([ds[i], ds[i + 1]]) for i in (0, 2)]
    model = UVHandDETR(**CFG, generator=torch.Generator().manual_seed(0), device="cpu")
    return {"batches": batches, "model": model,
            "world": (mano.synthetic_mano(0, True, device="cpu"),
                      mano.synthetic_mano(1, False, device="cpu"), bank)}


def children(spans, parent):
    return [s.name for s in spans if s.parent == parent]


def no_two_stages_overlap(spans):
    for step in {s.step for s in spans}:
        stages = sorted((s.start_ns, s.end_ns) for s in spans
                        if s.step == step and s.name in engine.TRAIN_STAGES)
        assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:])), step


def test_spans_nest_with_their_parents_and_steps():
    timing = {}
    with recording(timing, wait_ms="wait", outer_ms="outer"):
        for i, _ in steps(["a", "b"]):
            with span("outer"):
                with span("inner"):
                    pass
                with span("inner"):
                    pass
    got = [(s.name, s.parent, s.step) for s in timing["spans"]]
    assert got == [("wait", None, 0), ("outer", None, 0), ("inner", 1, 0), ("inner", 1, 0),
                   ("wait", None, 1), ("outer", None, 1), ("inner", 5, 1), ("inner", 5, 1)]
    for s in timing["spans"]:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = timing["spans"][s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert timing["wait_ms"] == [s.ms for s in timing["spans"] if s.name == "wait"]
    assert timing["outer_ms"] == [s.ms for s in timing["spans"] if s.name == "outer"]
    # a second recording into the same dict follows the first, its parents
    # indexing the whole list
    with recording(timing):
        with span("outer"):
            with span("inner"):
                pass
    assert [(s.name, s.parent) for s in timing["spans"][8:]] == [("outer", None), ("inner", 8)]


def test_nothing_is_recorded_with_the_recorder_off():
    with span("alone"):
        pass
    timing = {}
    with recording(None):
        with span("off"):
            pass
    with recording(timing):
        worker = threading.Thread(target=lambda: span("elsewhere").__enter__())
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
    assert timing == {"spans": []}
    assert list(steps(range(3))) == [(0, 0), (1, 1), (2, 2)]


def test_recorded_spans_line_up_with_the_profilers_ranges():
    timing = {}
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording(timing):
            for i in range(20):
                with span(f"s{i}"):
                    with span(f"s{i}.inner"):
                        x = torch.tanh(x @ x)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert len(timing["spans"]) == 40
    for s in timing["spans"]:
        e = events[s.name]
        assert abs(e.start_ns() - s.start_ns) < 1e6, s.name
        assert abs(e.start_ns() + e.duration_ns() - s.end_ns) < 1e6, s.name


def test_train_one_epoch_records_the_train_spans(world):
    model = world["model"]
    step = engine.make_fused_train_step(model, *world["world"], create_optimizer(model),
                                        img_res=float(RES), device="cpu")
    timing = {}
    engine.train_one_epoch(step, world["batches"], timing=timing, print_freq=10 ** 9)
    spans = timing["spans"]
    tops = [(i, s) for i, s in enumerate(spans) if s.parent is None]
    assert [(s.name, s.step) for _, s in tops] == [("wait", 0), ("step", 0), ("wait", 1),
                                                  ("step", 1)]
    for i, s in tops:
        if s.name == "step":
            assert children(spans, i) == TRAIN_CHILDREN
            crit = next(j for j, c in enumerate(spans) if c.parent == i and c.name == "criterion")
            assert children(spans, crit) == CRITERION_CHILDREN
    assert timing["wait_ms"] == [s.ms for s in spans if s.name == "wait"]
    assert timing["step_ms"] == [s.ms for s in spans if s.name == "step"]
    no_two_stages_overlap(spans)


def test_evaluate_records_the_eval_spans(world):
    step = engine.make_eval_step(world["model"], *world["world"], img_res=float(RES),
                                 device="cpu")
    timing = {}
    engine.evaluate(step, world["batches"], timing=timing)
    spans = timing["spans"]
    tops = [(i, s) for i, s in enumerate(spans) if s.parent is None]
    assert [(s.name, s.step) for _, s in tops] == [("wait", 0), ("batch", 0), ("wait", 1),
                                                  ("batch", 1)]
    for i, s in tops:
        if s.name == "batch":
            assert children(spans, i) == EVAL_CHILDREN
    assert set(timing) == {"spans", "batch_ms"}
    assert timing["batch_ms"] == [s.ms for s in spans if s.name == "batch"]
    no_two_stages_overlap(spans)


def made_up_spans(loop):
    """Three steps of hand-made spans: each span `name` of step k lasts
    (k + 1) ms, the `read` twice in step 2, `wait` 5 ms."""
    top = "step" if loop == "train" else "batch"
    names = [s for lp, s in READERS.values() if lp == loop and s != "wait"]
    spans, t = [], 0
    for k in range(3):
        spans.append(("wait", None, k, t, t + 5_000_000))
        t += 5_000_000
        parent = len(spans)
        spans.append((top, None, k, t, t + 10 ** 9))
        for name in names + (["read"] if k == 2 else []):
            spans.append((name, parent, k, t, t + (k + 1) * 1_000_000))
    return spans


@pytest.mark.parametrize("metric", sorted(READERS))
def test_each_span_reader_reads_the_median_of_its_loop(metric):
    loop, name = READERS[metric]
    other = "eval" if loop == "train" else "train"
    read = spec.reader(metric)
    spans = made_up_spans(loop)
    r = run.Readings(loop, 4, {}, setup_s=1.0, window_s=3.0, steps=3, timing={"spans": spans})
    # the median of 1, 2 and 3 ms, or of 1, 2 and 6 ms for the read
    want = 5.0 if name == "wait" else 2.0
    assert read(r) == pytest.approx(want)
    assert read(run.Readings(other, 4, {}, 1.0, timing={"spans": made_up_spans(other)})) is None
    assert read(run.Readings(loop, 4, {}, 1.0, timing={"step_ms": [1.0]})) is None
    no_name = [s for s in spans if s[0] != name]
    assert read(run.Readings(loop, 4, {}, 1.0, timing={"spans": no_name})) is None
