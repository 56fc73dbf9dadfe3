"""The port's measurement scripts (`uvhand_tpu_torch/scripts/`) on the CPU.

  - `bench_msda`: its inputs are the TPU script's draws for the same seed
    (the TPU script run with its op patched to record what it is given:
    value and locations bit for bit, the attention normalised in float32
    within 1e-6: XLA's sum and division round otherwise), and its plain route equals JAX `ms_deform_attn(impl="xla")`
    on the same numpy inputs, the forward and the gradients of out.mean()
    with respect to value, locations and attention, within 1e-5 of each
    tensor's max, at B=1 with uniform locations (Lq 24) and with `--local`
    (Lq = S = 1045); the script's own run prints its JSON line (no device
    time, no kernel calls on the CPU);
  - `profile_step`: a tiny model's profiled step on the CPU; the report's
    categories sum to its total, the top ops are listed, and
    `--report-only` reads the saved profile back to the same figures;
  - `bench_epoch`: `--device cpu` prints the TPU script's keys with a
    finite rate; `--host_only` prints its keys without touching CUDA, and
    `--scan_workers` (in a process of its own: its process workers fork)
    its rows for both modes;
  - `ab_enc_lite` and `ab_temporal` at a tiny size: the summary's keys are
    the TPU scripts' (`scripts/ab_enc_lite.py:174-194`,
    `scripts/ab_temporal.py:150-162`), and the losses are finite.
The numbers are CPU numbers; only their form is checked.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from uvhand_tpu_torch.scripts import ab_enc_lite, ab_temporal, bench_epoch, bench_msda, \
    profile_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--enc_layers", "2", "--dec_layers", "1", "--hidden_dim", "32",
        "--dim_feedforward", "64", "--nheads", "4", "--num_queries", "12", "--img_res", "64"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ bench_msda


def tpu_script_draws(monkeypatch, argv):
    """The (value, locations, attention) that `scripts/bench_msda.py` gives
    its op outside jit (its numerics check), with the op patched to record
    them and the scan's calls answered with zeros."""
    import jax
    import jax.numpy as jnp

    import uvhand_tpu.ops.msda as jmsda
    import uvhand_tpu.utils.cache as jcache

    seen = []

    def record(value, shapes, loc, attn, impl="xla"):
        if not isinstance(value, jax.core.Tracer):
            seen.append(tuple(np.asarray(x) for x in (value, loc, attn)))
        return jnp.zeros(loc.shape[:2] + (value.shape[2] * value.shape[3],), value.dtype)

    monkeypatch.setattr(jmsda, "ms_deform_attn", record)
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location("tpu_bench_msda",
                                                  os.path.join(ROOT, "scripts", "bench_msda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["bench_msda.py", *argv])
    mod.main()
    return seen[0]


@pytest.mark.parametrize("local, lq", [(False, 24), (True, 1045)], ids=["uniform", "local"])
def test_bench_msda_draws_the_tpu_scripts_inputs(local, lq, monkeypatch):
    argv = ["--impl", "pallas", "--batch", "1", "--lq", str(lq), "--steps", "1", "--mode", "fwd"]
    value, loc, attn = tpu_script_draws(monkeypatch, argv + (["--local"] if local else []))
    v, lc, a = bench_msda.op_inputs(1, lq, local, torch.float32, torch.device("cpu"))
    np.testing.assert_array_equal(v.numpy(), value)
    np.testing.assert_array_equal(lc.numpy(), loc)
    np.testing.assert_allclose(a.numpy(), attn, rtol=1e-6, atol=0)
    if local:  # each query's cell centre on its level, a few cells' spread
        assert 0.0 < np.abs(loc - loc.mean(axis=(2, 3, 4), keepdims=True)).mean() < 0.05


@pytest.mark.parametrize("local, lq", [(False, 24), (True, 1045)], ids=["uniform", "local"])
def test_bench_msda_plain_route_equals_jax_xla(local, lq):
    import jax
    import jax.numpy as jnp

    from uvhand_tpu.ops.msda import ms_deform_attn

    v, lc, a = bench_msda.op_inputs(1, lq, local, torch.float32, torch.device("cpu"))
    out = bench_msda.forward(v, lc, a, "torch")
    grads = bench_msda.gradients(v, lc, a, "torch")
    jv, jl, ja = (jnp.asarray(t.numpy()) for t in (v, lc, a))

    def loss(*xs):
        return ms_deform_attn(*xs[:1], bench_msda.SHAPES, *xs[1:], impl="xla").mean()

    jout = ms_deform_attn(jv, bench_msda.SHAPES, jl, ja, impl="xla")
    jgrads = jax.grad(lambda x, y, z: loss(x, y, z), argnums=(0, 1, 2))(jv, jl, ja)
    for name, got, want in zip(("out", "dvalue", "dloc", "dattn"), (out, *grads),
                               (jout, *jgrads)):
        want = np.asarray(want)
        assert got.shape == want.shape, name
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (name, err, np.abs(want).max())


def test_bench_msda_runs_and_prints_its_line(capsys):
    res = bench_msda.main(["--device", "cpu", "--batch", "1", "--lq", "8", "--steps", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(res))
    assert lines[0].startswith("kernel float32 fwd: ") and "device not measured" in lines[0]
    assert res["calls"] == {"fwd": 0, "grad": 0} and res["fwd_device_ms"] is None
    assert set(res["max_abs_err"]) == {"out", "dvalue", "dloc", "dattn"}
    assert res["bound_by"] in ("bytes", "operations") and res["grad_bound_ms"] > res["bound_ms"]


# ------------------------------------------------------------ profile_step


def test_profile_step_reports_categories_that_sum_to_the_total(tmp_path, capsys):
    logdir = str(tmp_path / "prof")
    rep = profile_step.main([*TINY, "--batch", "2", "--steps", "1", "--logdir", logdir,
                             "--top", "5", "--trace"])
    out = capsys.readouterr().out
    assert rep["source"].startswith("host") and rep["busy_share"] is None
    assert math.isclose(sum(rep["by_category"].values()), rep["total_us"], rel_tol=1e-9)
    assert rep["total_us"] > 0 and rep["ops_per_step"] > 0
    assert len(rep["top"]) == 5 and all(us > 0 for _, _, us in rep["top"])
    assert rep["top"][0][0] in out and "-- by category --" in out
    assert set(rep["by_category"]) <= {"GEMM/conv", "copies", "elementwise/reduction", "other"}
    assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0
    again = profile_step.main(["--report-only", "--logdir", logdir, "--top", "5"])
    assert again["total_us"] == rep["total_us"] and again["top"] == rep["top"]
    # the card's kernels by their names
    assert profile_step.category("void msda_bwd_staged_kernel<float>(float const*)") == \
        "msda: msda_bwd_staged_kernel"
    assert profile_step.category("sm90_xmma_gemm_f32f32_tf32f32_f32") == "GEMM/conv"
    assert profile_step.category("Memcpy DtoD (Device -> Device)") == "copies"


# ------------------------------------------------------------ bench_epoch


def test_bench_epoch_trains_an_epoch_on_the_cpu():
    (row,) = bench_epoch.main([*TINY, "--frames", "8", "--batch", "2", "--workers", "2"])
    assert set(row) == {"metric", "value", "unit", "steps", "batch", "note"}  # :128-135
    assert row["metric"] == "epoch_frames_per_sec" and (row["steps"], row["batch"]) == (4, 2)
    assert math.isfinite(row["value"]) and row["value"] > 0


def test_bench_epoch_host_only_never_touches_cuda(monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("the host pipeline touched CUDA")

    for name in ("is_available", "device_count", "init", "current_device", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    (row,) = bench_epoch.main(["--host_only", "--frames", "8", "--batch", "2", "--workers",
                               "2"])
    assert set(row) == {"metric", "value", "unit", "workers", "mode"}  # :112-116
    assert row["metric"] == "host_pipeline_frames_per_sec" and row["value"] > 0
    # both modes; the process workers fork, so not from this process, which holds JAX
    out = subprocess.run([sys.executable, "-m", "uvhand_tpu_torch.scripts.bench_epoch",
                          "--scan_workers", "1", "--frames", "6", "--batch", "2"], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert [(r["mode"], r["workers"]) for r in rows] == [("thread", 1), ("process", 1)]
    assert all(set(r) == {"mode", "workers", "host_frames_per_sec"}  # :102-104
               and r["host_frames_per_sec"] > 0 for r in rows)


# ------------------------------------------------------------ the A/B studies

VARIANT_KEYS = {"chunk_means", "last60_mean", "steps", "wall_s", "heldout_metrics"}


def test_ab_enc_lite_summary_has_the_tpu_scripts_keys(tmp_path):
    s = ab_enc_lite.main([*TINY, "--chunks", "1", "--scan", "2", "--batch", "2",
                          "--eval_metrics", "--train_batches", "2", "--variants",
                          "dense,lite2", "--out", str(tmp_path)])
    assert set(s) == {"metric", "variants", "last60_ratio_lite2_over_dense", "dense", "lite2",
                      "heldout"}
    assert s["metric"] == "ab_enc_lite_heldout_metrics" and s["variants"] == ["dense", "lite2"]
    for name in ("dense", "lite2"):
        assert set(s[name]) == VARIANT_KEYS and s[name]["steps"] == 2
        assert set(s[name]["last60_mean"]) == set(ab_enc_lite.TRACKED)
        assert all(math.isfinite(v) for v in s[name]["last60_mean"].values())
        assert s["heldout"][name] == s[name]["heldout_metrics"]
        assert os.path.exists(tmp_path / f"ab_enc_lite_{name}.npz")
    assert s["dense"]["last60_mean"] != s["lite2"]["last60_mean"]  # two models


def test_ab_temporal_summary_has_the_tpu_scripts_keys():
    s = ab_temporal.main([*TINY, "--chunks", "1", "--scan", "2", "--batch", "4", "--window",
                          "2"])
    names = ["none", "lstm", "vivit"]
    assert set(s) == {"metric", "window", "variants", "last60_ratio_lstm_over_none",
                      "last60_ratio_vivit_over_none", *names}
    assert (s["metric"], s["window"], s["variants"]) == ("ab_temporal_heads", 2, names)
    for name in names:
        assert set(s[name]) == VARIANT_KEYS - {"chunk_means"} and s[name]["steps"] == 2
        assert all(math.isfinite(v) for v in s[name]["last60_mean"].values())
        assert set(s[name]["heldout_metrics"]) >= {"aae", "mpjpe/ra/h"}
    assert "loss/mano/cam_t/r/temporal" in s["lstm"]["last60_mean"]
    assert "loss/mano/cam_t/r/temporal" not in s["none"]["last60_mean"]
