"""The port's CLI (`uvhand_tpu_torch.cli.main`) and checkpoints, on the CPU.

  - the flag surface equals the JAX CLI's (every flag's dest and default,
    but `--device`, whose default means the card);
  - `--config_file` / `--options` merge as the JAX CLI merges them;
  - a checkpoint round trip: state dict, optimizer state and step equal;
    `not_use_params` keeps fresh values; a mismatched optimizer is restored
    tolerantly; `list_checkpoints` sorts by epoch; a resumed schedule
    continues at its step's learning rate;
  - every option the port does not run exits with a message naming its
    ROADMAP item; `--device cuda` (or the default) without a card raises;
  - the A/B: the port CLI trains one `--debug` step of a 1+1-layer d=64
    model (B=8, `--device cpu`) and writes out/0/checkpoint.pth, loss.txt
    and results.txt; then `--eval --resume` of that file through the port
    CLI and through the JAX CLI on the same root, with the default metrics
    (the sequence metrics mdev/h, acc/h, acc/o included), give scores that
    agree within 1e-2 mm + 1e-4 relative (`tests/test_torch_eval.py`'s
    tolerance; NaN where both are NaN).
"""

import json
import os

import numpy as np
import pytest
import torch

from uvhand_tpu.cli.main import get_args_parser as jax_parser
from uvhand_tpu.cli.main import main as jax_main
from uvhand_tpu_torch.cli.main import get_args_parser, main
from uvhand_tpu_torch.data import arctic
from uvhand_tpu_torch.geometry import objects
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.train import checkpoint as ckpt
from uvhand_tpu_torch.train.state import (create_optimizer, onecycle_schedule, scheduled,
                                          set_schedule_step)

from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

TINY = ["--enc_layers", "1", "--dec_layers", "1", "--hidden_dim", "64", "--dim_feedforward",
        "64", "--nheads", "4", "--num_queries", "12", "--dropout", "0.0"]


def test_flag_surface_equals_the_jax_clis():
    ours = {a.dest: a for a in get_args_parser()._actions}
    ref = {a.dest: a for a in jax_parser()._actions}
    assert sorted(ours) == sorted(ref)
    for dest, action in ref.items():
        assert sorted(ours[dest].option_strings) == sorted(action.option_strings), dest
        if dest != "device":
            assert ours[dest].default == action.default, dest
            assert ours[dest].nargs == action.nargs and ours[dest].choices == action.choices
    assert ours["device"].default is None


def test_config_file_merges_as_the_jax_cli(tmp_path):
    cfg = tmp_path / "cfg.py"
    cfg.write_text("custom_knob = 7\nlr = 9.9\nnested = dict(a=1, b=2)\n")
    args = get_args_parser().parse_args(
        ["--config_file", str(cfg), "--options", "custom_knob=8", "nested.b=3",
         "--output_dir", str(tmp_path / "out"), "--sgd"])
    with pytest.raises(SystemExit, match="--sgd"):  # stops after the merge
        main(args)
    raw = json.load(open(tmp_path / "out" / "config_args_raw.json"))
    assert raw["custom_knob"] == 8 and raw["nested"] == {"a": 1, "b": 3}
    assert raw["lr"] == 2e-4  # the arguments win over the file


def tiny_model(seed=0):
    return UVHandDETR(num_queries=4, num_encoder_layers=1, num_decoder_layers=1, d_model=32,
                      n_heads=4, dim_feedforward=32, generator=torch.Generator().manual_seed(seed),
                      device="cpu")


def one_update(model, optimizer):
    loss = sum((p.float() ** 2).sum() for p in model.parameters())
    optimizer.zero_grad()
    loss.backward()
    optimizer.step()


def test_checkpoint_round_trip(tmp_path):
    model = tiny_model(0)
    opt = create_optimizer(model)
    one_update(model, opt)
    path = ckpt.save_checkpoint(str(tmp_path), 3, model, opt, step=17, extra={"epoch": 3})
    assert path == str(tmp_path / "3") and os.path.exists(tmp_path / "3" / "checkpoint.pth")
    assert json.load(open(tmp_path / "3.meta.json")) == {"epoch": 3}
    saved = torch.load(tmp_path / "3" / "checkpoint.pth", weights_only=False)
    assert set(saved) == {"model", "optimizer", "step", "epoch"}

    fresh = tiny_model(1)
    fresh_opt = create_optimizer(fresh)
    info = ckpt.load_checkpoint(path, fresh, fresh_opt)
    assert info == {"step": 17, "epoch": 3, "optimizer_restored": True}
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = opt.state_dict(), fresh_opt.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb["state"][i][k])), (i, k)

    # not_use_params: the matched tensors keep their fresh values
    other = tiny_model(2)
    before = {k: v.clone() for k, v in other.state_dict().items()}
    ckpt.load_checkpoint(path, other, None, not_use_params=["cls_embed", "input_proj"])
    for k, v in other.state_dict().items():
        kept = "cls_embed" in k or "input_proj" in k
        assert torch.equal(v, before[k] if kept else model.state_dict()[k]), k
    assert any("cls_embed" in k for k in before)

    # a mismatched optimizer: the parameters load, the optimizer stays fresh
    small = tiny_model(3)
    mismatched = torch.optim.AdamW([next(small.parameters())], lr=1e-3)
    info = ckpt.load_checkpoint(path, small, mismatched)
    assert info["optimizer_restored"] is False and info["step"] == 0
    assert mismatched.state_dict()["state"] == {}
    assert torch.equal(next(small.parameters()), next(model.parameters()))

    # a reference-layout .pth (parameters only) and a bare state dict
    torch.save({"model": model.state_dict()}, tmp_path / "ref.pth")
    torch.save(model.state_dict(), tmp_path / "bare.pth")
    for name in ("ref.pth", "bare.pth"):
        m = tiny_model(4)
        ckpt.load_torch_pth(str(tmp_path / name), m)
        assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                     model.state_dict().values()))
    with pytest.raises(KeyError, match="lacks"):
        torch.save({"model": {}}, tmp_path / "empty.pth")
        ckpt.load_torch_pth(str(tmp_path / "empty.pth"), tiny_model(5))


def test_list_checkpoints_sorts_by_epoch(tmp_path):
    for name in ("10", "2", "0", "x1", "3.meta"):
        (tmp_path / name).mkdir()
    (tmp_path / "7").write_text("")
    assert ckpt.list_checkpoints(str(tmp_path)) == [str(tmp_path / n) for n in ("0", "2", "10")]


def test_a_resumed_schedule_continues_at_its_step():
    model = tiny_model(0)
    sched = onecycle_schedule(2e-4, 100)
    ran = create_optimizer(model)
    sch = scheduled(ran, sched, 2e-4)
    for _ in range(37):
        ran.step()
        sch.step()
    resumed = create_optimizer(model)
    sch2 = scheduled(resumed, sched, 2e-4)
    set_schedule_step(sch2, 37)
    assert [g["lr"] for g in resumed.param_groups] == [g["lr"] for g in ran.param_groups]
    resumed.step()
    sch2.step()
    ran.step()
    sch.step()
    assert [g["lr"] for g in resumed.param_groups] == [g["lr"] for g in ran.param_groups]


UNPORTED = {
    "remat": ["--remat"], "enc_lite": ["--enc_lite"], "bf16_params": ["--bf16_params"],
    "sgd": ["--sgd"], "use_dn": ["--use_dn"], "dino": ["--modelname", "dino"],
    "arctic_lstm": ["--method", "arctic_lstm"], "temporal_head": ["--temporal_head", "lstm"],
    "train_smoothnet": ["--train_smoothnet"], "extract": ["--extract"],
    "extraction_mode": ["--extraction_mode", "submit_pose"],
    "visualization": ["--visualization"], "native_loader": ["--native_loader", "fast"],
    "learned_posenc": ["--position_embedding", "learned"],
    "feature_type": ["--feature_type", "local_fm"], "no_aux_loss": ["--no_aux_loss"],
    "backbone": ["--backbone", "swin_L"], "mp": ["--mp", "2"], "world_size": ["--world_size", "2"],
    "assembly": ["--dataset_file", "AssemblyHands"], "h2o": ["--dataset_file", "H2O"],
    "fpha": ["--dataset_file", "FPHA"],
}


@pytest.mark.parametrize("name", sorted(UNPORTED) + ["single_stage", "no_box_refine",
                                                     "WORLD_SIZE"])
def test_every_unported_option_exits_naming_its_roadmap_item(name, tmp_path, monkeypatch):
    argv = ["--output_dir", str(tmp_path), "--device", "cpu", "--two_stage", "--with_box_refine"]
    if name == "single_stage":
        argv.remove("--two_stage")
    elif name == "no_box_refine":
        argv.remove("--with_box_refine")
    elif name == "WORLD_SIZE":
        monkeypatch.setenv("WORLD_SIZE", "2")
    else:
        argv += UNPORTED[name]
    with pytest.raises(SystemExit, match=r"not ported yet: .*\(ROADMAP Queue 1 item"):
        main(get_args_parser().parse_args(argv))


@pytest.mark.parametrize("device", [None, "cuda"])
def test_the_card_without_a_card_raises(device, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--output_dir", str(tmp_path), "--two_stage", "--with_box_refine"]
    if device:
        argv += ["--device", device]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(get_args_parser().parse_args(argv))


def last_scores(path):
    lines = open(path).read().splitlines()
    return json.loads(lines[-1].replace("NaN", "null"))


def test_port_cli_trains_and_its_checkpoint_evaluates_as_in_the_jax_cli(tmp_path):
    data = tmp_path / "data"
    arctic.make_synthetic_root(str(data / "arctic"), num_seqs=1, frames=4, views=2, seed=0,
                               image_hw=(150, 210),
                               obj_bank=objects.synthetic_object_bank(2, device="cpu"))
    common = ["--dataset_file", "arctic", "--coco_path", str(data), "--two_stage",
              "--with_box_refine", *TINY, "--batch_size", "8", "--val_batch_size", "8",
              "--debug", "--num_debug", "1", "--num_workers", "2", "--epochs", "1"]
    out = tmp_path / "out"
    res = main(get_args_parser().parse_args(common + ["--output_dir", str(out), "--device",
                                                      "cpu"]))
    for name in ("0/checkpoint.pth", "0.meta.json", "loss.txt", "results.txt",
                 "running_cmd.json"):
        assert (out / name).exists(), name
    loss = last_scores(out / "loss.txt")
    assert set(loss) == {"epoch", "loss", "grad_norm"} and np.isfinite(loss["loss"])
    assert len(res["timing"]["step_ms"]) == 1 and len(res["timing"]["batch_ms"]) == 1

    resume = ["--eval", "--resume", str(out / "0" / "checkpoint.pth")]
    main(get_args_parser().parse_args(common + resume + ["--output_dir", str(tmp_path / "ev"),
                                                         "--device", "cpu"]))
    jax_main(jax_parser().parse_args(common + resume + ["--output_dir", str(tmp_path / "jev")]))
    header = "========== 8*1, 0iter =========="
    for d in ("ev", "jev"):
        assert open(tmp_path / d / "results.txt").read().splitlines()[0] == header
    ours, ref = last_scores(tmp_path / "ev" / "results.txt"), last_scores(
        tmp_path / "jev" / "results.txt")
    assert sorted(ours) == sorted(ref)
    assert {"mdev/h", "acc/h", "acc/o", "aae", "cdev/ho", "mpjpe/ra/h"} <= set(ours)
    assert np.isfinite(ours["acc/h"]) and np.isfinite(ours["acc/o"])
    for k, v in ref.items():
        if v is None:
            assert ours[k] is None, k
        else:
            assert abs(ours[k] - v) <= 1e-2 + 1e-4 * abs(v), (k, ours[k], v)
