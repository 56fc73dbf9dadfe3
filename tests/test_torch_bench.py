"""The port's bench (`python -m uvhand_tpu_torch.bench`) on the CPU.

A tiny model (1+2 layers, d 64, FFN 128, 4 heads, 12 queries, 64x64) on a
batch of 2, 2 steps or batches after the warm-up one: the first line is
the bf16 train headline with the root bench's keys, every line is JSON, the
window-32 temporal line times one window of 32 frames (bf16, remat), and
the Swin-L line times the model on a shrunken Swin; those two rows carry
the root bench's `note` and no `vs_baseline`. The window knobs
(UVHAND_BENCH_WINDOW, _SPLIT, _TEMPORAL) train on window batches with the
temporal head, skip serving where the batch keeps only its centre frames'
cameras, and drop the window-32 and Swin-L rows, as the root bench does.
The root bench's other knobs: _PROFILE writes a trace a line and still
prints the unprofiled rate, _REMAT overrides a row's remat, _SR trains the
bf16 lines with bfloat16 parameters, _ENC_LITE marks every row, and
_EXTRA_MODES=0 drops the window-32 and Swin-L rows. The DINO
model and the ConvNeXt backbone knobs (a shrunken ConvNeXt here) run the
DINO train step, which draws CDN queries every step. Without a
card and without `--device cpu` it raises. The numbers are CPU rates, not
the card's; only their form is checked.
"""

import json
import math
import os

import pytest
import torch

from uvhand_tpu_torch import bench

TINY = ["--device", "cpu", "--enc_layers", "1", "--dec_layers", "2", "--hidden_dim", "64",
        "--dim_feedforward", "128", "--nheads", "4", "--num_queries", "12", "--img_res", "64"]


def tiny_env(monkeypatch):
    """A shrunken Swin, a batch of 2, 2 timed calls, every other knob unset."""
    from uvhand_tpu_torch.models.backbones import swin

    monkeypatch.setattr(swin.SwinTransformer, "swin_l_384", classmethod(
        lambda cls, **kw: cls(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 1, 2, 4),
                              window_size=12, **kw)))
    monkeypatch.setattr(swin, "SWIN_L_CHANNELS", (32, 64, 128))
    monkeypatch.setenv("UVHAND_BENCH_BATCH", "2")
    monkeypatch.setenv("UVHAND_BENCH_SCAN", "2")
    for knob in ("DTYPE", "ONLY", "INFER", "LITE", "BUDGET_S", "ENC_LITE_HI", "MODEL",
                 "BACKBONE", "WINDOW", "SPLIT", "TEMPORAL", "PROFILE", "REMAT", "SR", "ENC_LITE",
                 "EXTRA_MODES"):
        monkeypatch.delenv(f"UVHAND_BENCH_{knob}", raising=False)


@pytest.fixture
def bench_env(monkeypatch):
    tiny_env(monkeypatch)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield monkeypatch
    torch.set_num_threads(n)


def run(capsys, argv=TINY):
    bench.main(argv)
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


@pytest.fixture(scope="module")
def default_lines():
    """The lines of one default run (the knobs unset)."""
    import io
    from contextlib import redirect_stdout

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = io.StringIO()
    try:
        with pytest.MonkeyPatch.context() as mp, redirect_stdout(out):
            tiny_env(mp)
            bench.main(TINY)
    finally:
        torch.set_num_threads(n)
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_headline_first_then_every_mode(default_lines):
    lines = default_lines
    head = lines[0]
    assert head["metric"] == "train_frames_per_sec_chip" and head["unit"] == "frames/s"
    assert head["dtype"] == "bfloat16" and head["batch"] == 2 and head["device"] == "cpu"
    assert math.isfinite(head["value"]) and head["value"] > 0
    assert head["vs_baseline"] == head["value"] / bench.REFERENCE_FPS_ESTIMATE
    assert [x["metric"] for x in lines[1:]] == [
        "train_frames_per_sec_chip_fp32", "train_frames_per_sec_chip_enc_lite",
        "infer_frames_per_sec_chip_enc_lite", "infer_frames_per_sec_chip",
        "train_frames_per_sec_chip_window32", "train_frames_per_sec_chip_swin",
        "infer_frames_per_sec_chip_fp32"]
    by = {x["metric"]: x for x in lines}
    swin = by["train_frames_per_sec_chip_swin"]
    assert (swin["backbone"], swin["dtype"], swin["batch"]) == ("swin_L_384_22k", "bfloat16", 2)
    assert head["backbone"] == "resnet50"
    w32 = by["train_frames_per_sec_chip_window32"]
    assert (w32["batch"], w32["window"], w32["dtype"], w32["remat"]) == (32, 32, "bfloat16", True)
    assert w32["split_window"] and w32["temporal_head"] == "none" and not head["remat"]
    timed = [x for x in lines if "value" in x]
    assert len(timed) == 8 and all(math.isfinite(x["value"]) and x["value"] > 0 for x in timed)
    assert by["infer_frames_per_sec_chip_enc_lite"]["batch"] == 8
    assert by["infer_frames_per_sec_chip_enc_lite"]["enc_lite_hi_every"] == 6


def test_other_configurations_rows_carry_a_note_and_no_vs_baseline(default_lines):
    """The root bench's rule: the A100 estimate is arctic_sf on the R50 at
    B=16, so the window-32 and Swin-L rows get a note in its place."""
    by = {x["metric"]: x for x in default_lines}
    assert by["train_frames_per_sec_chip_window32"]["note"] == (
        "BASELINE config-3 temporal train, remat")
    assert by["train_frames_per_sec_chip_swin"]["note"] == "BASELINE config-2 backbone"
    for metric in bench.NOTES:
        assert "vs_baseline" not in by[metric]
    for metric in ("train_frames_per_sec_chip", "train_frames_per_sec_chip_fp32",
                   "train_frames_per_sec_chip_enc_lite"):
        assert by[metric]["vs_baseline"] == by[metric]["value"] / bench.REFERENCE_FPS_ESTIMATE
        assert "note" not in by[metric]
    assert not any("sr" in x or "trace" in x for x in default_lines)


def test_knobs_and_the_budget(bench_env, capsys):
    bench_env.setenv("UVHAND_BENCH_ONLY", "infer")
    bench_env.setenv("UVHAND_BENCH_DTYPE", "float32")
    lines = run(capsys)
    assert [(x["metric"], x["dtype"]) for x in lines] == [("infer_frames_per_sec_chip",
                                                           "float32")]
    for knob in ("ONLY", "DTYPE"):
        bench_env.delenv(f"UVHAND_BENCH_{knob}")
    bench_env.setenv("UVHAND_BENCH_BUDGET_S", "0")
    bench_env.setenv("UVHAND_BENCH_LITE", "0")
    bench_env.setenv("UVHAND_BENCH_INFER", "0")
    lines = run(capsys)
    assert lines[0]["metric"] == "train_frames_per_sec_chip"  # the headline ignores the budget
    assert {x["metric"]: x.get("skipped") for x in lines[1:]} == {
        "train_frames_per_sec_chip_fp32": "budget",
        "train_frames_per_sec_chip_window32": "budget",
        "train_frames_per_sec_chip_swin": "budget"}


def test_the_dino_and_convnext_knobs(bench_env, capsys):
    from uvhand_tpu_torch.models import detr
    from uvhand_tpu_torch.models.backbones import convnext

    bench_env.setattr(convnext, "CONVNEXT_XL_DEPTHS", (1, 1, 1, 1))
    bench_env.setattr(convnext, "CONVNEXT_XL_DIMS", (16, 32, 64, 128))
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return prepare_cdn(*a, **kw)

    prepare_cdn = detr.prepare_cdn
    bench_env.setattr(detr, "prepare_cdn", counted)
    for knob, value in (("MODEL", "dino"), ("BACKBONE", "convnext"), ("LITE", "0"),
                        ("INFER", "0")):
        bench_env.setenv(f"UVHAND_BENCH_{knob}", value)
    lines = run(capsys)
    timed = [x for x in lines if "value" in x]
    assert [x["metric"] for x in timed] == ["train_frames_per_sec_chip",
                                            "train_frames_per_sec_chip_fp32",
                                            "train_frames_per_sec_chip_window32",
                                            "train_frames_per_sec_chip_swin"]
    assert all(x["model"] == "dino" for x in timed)
    assert [x["backbone"] for x in timed] == ["convnext_xlarge_22k"] * 3 + ["swin_L_384_22k"]
    assert all(math.isfinite(x["value"]) and x["value"] > 0 for x in timed)
    assert len(calls) == 4 * 3  # every train step (warm-up + 2) of the four modes
    bench_env.setenv("UVHAND_BENCH_BACKBONE", "swin")
    bench_env.setenv("UVHAND_BENCH_DTYPE", "bfloat16")  # the headline alone
    (head,) = run(capsys)
    assert (head["metric"], head["backbone"]) == ("train_frames_per_sec_chip", "swin_L_384_22k")
    assert math.isfinite(head["value"]) and head["value"] > 0


def test_the_window_knobs(bench_env, capsys):
    """UVHAND_BENCH_WINDOW=2 with a batch of 4: 2 windows of 2 frames centred
    on frames, the centre frames' targets (SPLIT=0) and the lstm head; the
    serving lines skip (no camera of the other frames), and neither the
    window32 nor the Swin-L line runs beside a window batch (the root
    bench's `and not window`)."""
    for knob, value in (("WINDOW", "2"), ("SPLIT", "0"), ("TEMPORAL", "lstm"), ("LITE", "0"),
                        ("BATCH", "4")):
        bench_env.setenv(f"UVHAND_BENCH_{knob}", value)
    lines = run(capsys)
    assert [x["metric"] for x in lines] == [
        "train_frames_per_sec_chip", "train_frames_per_sec_chip_fp32",
        "infer_frames_per_sec_chip", "infer_frames_per_sec_chip_fp32"]
    for row in lines[:2]:
        assert (row["batch"], row["window"], row["split_window"], row["temporal_head"],
                row["remat"]) == (4, 2, False, "lstm", False)
        assert math.isfinite(row["value"]) and row["value"] > 0
    assert all("centre frames" in x["skipped"] for x in lines if x["metric"].startswith("infer"))


def test_the_card_without_a_card_raises(bench_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(TINY[2:])


def test_the_profile_knob_writes_a_trace_a_line(bench_env, capsys, tmp_path):
    bench_env.setenv("UVHAND_BENCH_PROFILE", str(tmp_path))
    bench_env.setenv("UVHAND_BENCH_DTYPE", "bfloat16")
    (head,) = run(capsys)
    assert head["trace"] == str(tmp_path / "bfloat16" / "train_frames_per_sec_chip.json")
    assert math.isfinite(head["value"]) and head["value"] > 0
    trace = json.load(open(head["trace"]))
    assert any(e.get("name") == "backward" for e in trace["traceEvents"])  # a train stage
    bench_env.setenv("UVHAND_BENCH_ONLY", "infer")
    (row,) = run(capsys)
    assert row["trace"] == str(tmp_path / "infer_bfloat16" / "infer_frames_per_sec_chip.json")
    assert os.path.getsize(row["trace"]) > 0 and math.isfinite(row["value"])


def test_the_remat_knob_overrides_the_rows_remat(bench_env, capsys):
    bench_env.setenv("UVHAND_BENCH_DTYPE", "bfloat16")
    bench_env.setenv("UVHAND_BENCH_REMAT", "1")  # 2 frames: off by the automatic choice
    (head,) = run(capsys)
    assert head["remat"] is True and math.isfinite(head["value"])
    bench_env.setenv("UVHAND_BENCH_REMAT", "0")
    bench_env.setenv("UVHAND_BENCH_WINDOW", "12")
    bench_env.setenv("UVHAND_BENCH_BATCH", "24")  # 2 windows of 12: 24 frames, on by default
    (head,) = run(capsys)
    assert (head["batch"], head["remat"]) == (24, False)


def test_the_sr_knob_trains_the_bf16_lines_with_bf16_parameters(bench_env, capsys):
    bench_env.setenv("UVHAND_BENCH_SR", "1")
    bench_env.setenv("UVHAND_BENCH_DTYPE", "bfloat16")
    (head,) = run(capsys)
    assert head["sr"] is True and head["param_dtypes"] == ["torch.bfloat16"]
    assert math.isfinite(head["value"]) and head["value"] > 0
    bench_env.setenv("UVHAND_BENCH_DTYPE", "float32")  # SR takes the bf16 lines only
    (head,) = run(capsys)
    assert "sr" not in head and math.isfinite(head["value"])


def test_the_enc_lite_knob_marks_every_row(bench_env, capsys):
    for knob, value in (("ENC_LITE", "1"), ("LITE", "0"), ("EXTRA_MODES", "0")):
        bench_env.setenv(f"UVHAND_BENCH_{knob}", value)
    lines = run(capsys)
    assert [x["metric"] for x in lines] == [
        "train_frames_per_sec_chip", "train_frames_per_sec_chip_fp32",
        "infer_frames_per_sec_chip", "infer_frames_per_sec_chip_fp32"]
    assert all(x["enc_lite"] is True and x["enc_lite_hi_every"] == 3 for x in lines)
    assert all(math.isfinite(x["value"]) and x["value"] > 0 for x in lines)


def test_the_extra_modes_knob_drops_both_rows(bench_env, capsys):
    for knob, value in (("EXTRA_MODES", "0"), ("LITE", "0"), ("INFER", "0")):
        bench_env.setenv(f"UVHAND_BENCH_{knob}", value)
    lines = run(capsys)
    assert [x["metric"] for x in lines] == ["train_frames_per_sec_chip",
                                            "train_frames_per_sec_chip_fp32"]
