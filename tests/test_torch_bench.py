"""The port's bench (`python -m uvhand_tpu_torch.bench`) on the CPU.

A tiny model (1+2 layers, d 64, FFN 128, 4 heads, 12 queries, 64x64) on a
batch of 2, 2 steps or batches after the warm-up one: the first line is
the bf16 train headline with the root bench's keys, every line is JSON, the
window-32 temporal line times one window of 32 frames (bf16, remat), and
the not-ported Swin mode names its ROADMAP item and times nothing. The
window knobs (UVHAND_BENCH_WINDOW, _SPLIT, _TEMPORAL) train on window
batches with the temporal head and skip serving where the batch keeps only
its centre frames' cameras. The DINO
model and the ConvNeXt backbone knobs (a shrunken ConvNeXt here) run the
DINO train step, which draws CDN queries every step. Without a
card and without `--device cpu` it raises. The numbers are CPU rates, not
the card's; only their form is checked.
"""

import json
import math

import pytest
import torch

from uvhand_tpu_torch import bench

TINY = ["--device", "cpu", "--enc_layers", "1", "--dec_layers", "2", "--hidden_dim", "64",
        "--dim_feedforward", "128", "--nheads", "4", "--num_queries", "12", "--img_res", "64"]


@pytest.fixture
def bench_env(monkeypatch):
    from uvhand_tpu_torch.models.backbones import swin

    monkeypatch.setattr(swin.SwinTransformer, "swin_l_384", classmethod(
        lambda cls, **kw: cls(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 1, 2, 4),
                              window_size=12, **kw)))
    monkeypatch.setattr(swin, "SWIN_L_CHANNELS", (32, 64, 128))
    monkeypatch.setenv("UVHAND_BENCH_BATCH", "2")
    monkeypatch.setenv("UVHAND_BENCH_SCAN", "2")
    for knob in ("DTYPE", "ONLY", "INFER", "LITE", "BUDGET_S", "ENC_LITE_HI", "MODEL",
                 "BACKBONE", "WINDOW", "SPLIT", "TEMPORAL"):
        monkeypatch.delenv(f"UVHAND_BENCH_{knob}", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield monkeypatch
    torch.set_num_threads(n)


def run(capsys, argv=TINY):
    bench.main(argv)
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_headline_first_then_every_mode(bench_env, capsys):
    lines = run(capsys)
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
    serving lines skip (no camera of the other frames), and no window32
    line runs beside a window batch."""
    for knob, value in (("WINDOW", "2"), ("SPLIT", "0"), ("TEMPORAL", "lstm"), ("LITE", "0"),
                        ("BATCH", "4")):
        bench_env.setenv(f"UVHAND_BENCH_{knob}", value)
    lines = run(capsys)
    assert [x["metric"] for x in lines] == [
        "train_frames_per_sec_chip", "train_frames_per_sec_chip_fp32",
        "infer_frames_per_sec_chip", "train_frames_per_sec_chip_swin",
        "infer_frames_per_sec_chip_fp32"]
    for row in lines[:2]:
        assert (row["batch"], row["window"], row["split_window"], row["temporal_head"],
                row["remat"]) == (4, 2, False, "lstm", False)
        assert math.isfinite(row["value"]) and row["value"] > 0
    assert all("centre frames" in x["skipped"] for x in lines if x["metric"].startswith("infer"))


def test_the_card_without_a_card_raises(bench_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(TINY[2:])
