"""The port's CLI (`uvhand_tpu_torch.cli.main`) and checkpoints, on the CPU.

  - the flag surface equals the JAX CLI's (every flag's dest and default,
    but `--device`, whose default means the card);
  - `--config_file` / `--options` merge as the JAX CLI merges them;
  - a checkpoint round trip: state dict, optimizer state and step equal;
    `not_use_params` keeps fresh values; a mismatched optimizer is restored
    tolerantly; `list_checkpoints` sorts by epoch; a resumed schedule
    continues at its step's learning rate;
  - every option the port does not run (`--mp > 1`) exits with a message
    naming its ROADMAP item; `--extract`, `--extraction_mode`, `--eval
    --visualization` and `--native_loader` run tiny through their routes,
    and `--feature_type local_fm` exits naming the JAX CLI's failure (the Swin-L backbone and the COCO-format datasets run:
    `tests/test_torch_swin.py`, `tests/test_torch_coco.py`); the temporal
    routes run: `--method
    arctic_lstm` with each `--temporal_head` trains, evaluates and resumes,
    `--train_smoothnet` writes the smoother and `--smooth_resume` resumes
    it apart from the base model, and a temporal head without windows exits
    with the JAX CLI's message, as the JAX CLI does; the DINO variant, `--use_dn` and
    the ConvNeXt backbone are taken; `--onecyclelr` schedules over 12
    epochs for dino and 32 otherwise; `-c configs/DINO/DINO_4scale.py`
    adds only the keys the flags lack; `--device cuda` (or the default)
    without a card raises;
  - the A/B: the port CLI trains one `--debug` step of a 1+1-layer d=64
    model (B=8, `--device cpu`) and writes out/0/checkpoint.pth, loss.txt
    and results.txt; then `--eval --resume` of that file through the port
    CLI and through the JAX CLI on the same root, with the default metrics
    (the sequence metrics mdev/h, acc/h, acc/o included), give scores that
    agree within 1e-2 mm + 1e-4 relative (`tests/test_torch_eval.py`'s
    tolerance; NaN where both are NaN); the same A/B for the default
    single-stage model and for a checkpoint trained with `--bf16_params`
    (at 128x128);
  - the model and training options (`--remat`, `--enc_lite`, `--sgd`,
    `--position_embedding learned`, `--no_aux_loss`) each train a step,
    evaluate, and resume into `--eval`; so does `--modelname dino
    --two_stage`, with the ResNet and with a shrunken ConvNeXt; `--two_stage` without
    `--with_box_refine` raises as the JAX model fails; bfloat16 parameters
    round-trip through a checkpoint with their optimizer state.
"""

import json
import os

import numpy as np
import pytest
import torch

from uvhand_tpu.cli.main import get_args_parser as jax_parser
from uvhand_tpu.cli.main import main as jax_main
from uvhand_tpu_torch.cli.main import check_ported, get_args_parser, main, onecycle_epochs
from uvhand_tpu_torch.data import arctic
from uvhand_tpu_torch.geometry import objects
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.models.temporal import smoothnet
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
         "--output_dir", str(tmp_path / "out"), "--mp", "2"])
    with pytest.raises(SystemExit, match="--mp"):  # stops after the merge
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
    "mp": ["--mp", "2"],
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_every_unported_option_exits_naming_its_roadmap_item(name, tmp_path):
    argv = ["--output_dir", str(tmp_path), "--device", "cpu", "--two_stage", "--with_box_refine",
            *UNPORTED[name]]
    with pytest.raises(SystemExit, match=r"not ported yet: .*\(ROADMAP Queue 1 item"):
        main(get_args_parser().parse_args(argv))


#: the options that exited as unported before the export routes and the
#: native loader were ported, each run tiny through its route
ROUTES = {
    "extract": ["--extract"],
    "extraction_mode": ["--extraction_mode", "submit_pose"],
    "visualization": ["--eval", "--visualization"],
    "native_loader": ["--native_loader", "fast"],
    "feature_type": ["--feature_type", "local_fm"],
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_each_formerly_unported_option_runs_its_route(name, small_root, tmp_path):
    """`--extract`, `--extraction_mode`, `--eval --visualization` and
    `--native_loader` run on the CPU and write what they should;
    `--feature_type local_fm` exits naming the JAX CLI's failure (ROADMAP
    Queue 3), not as unported."""
    out = tmp_path / "out"
    argv = small_root + ["--two_stage", "--with_box_refine", "--output_dir", str(out),
                         "--device", "cpu", *ROUTES[name]]
    if name == "feature_type":
        with pytest.raises(SystemExit, match=r"--feature_type local_fm .*the JAX CLI .*fails"):
            main(get_args_parser().parse_args(argv))
        return
    res = main(get_args_parser().parse_args(argv))
    if name == "extract":
        assert any(f.endswith(".pkl") for _, _, fs in os.walk(res["features"]) for f in fs)
    elif name == "extraction_mode":
        assert any(f == "pred.mano.pose.r.pt" for _, _, fs in os.walk(res["submission"])
                   for f in fs)
    elif name == "visualization":
        assert sorted(os.listdir(out / "vis"))[0] == "00000.png"
    else:  # every image of the epoch's step and eval through the C call
        assert res["image_routes"]["train"]["native"] == 8
        assert set(res["image_routes"]["train"]) == {"native"}
        assert np.isfinite(res["epochs"][0]["stats"]["loss"])


@pytest.mark.parametrize("flags", [["--use_dn"], ["--modelname", "dino"],
                                   ["--backbone", "convnext_xlarge_22k"]],
                         ids=["use_dn", "dino", "convnext"])
def test_dino_and_convnext_are_ported(flags):
    check_ported(get_args_parser().parse_args(flags))


@pytest.mark.parametrize("modelname,epochs", [("deformable_detr", 32), ("dino", 12)])
def test_onecyclelr_schedules_over_the_models_epochs(modelname, epochs):
    """32 epochs for deformable_detr, 12 for dino, as the JAX CLI."""
    args = get_args_parser().parse_args(["--modelname", modelname, "--onecyclelr"])
    assert onecycle_epochs(args) == epochs


def test_the_dino_config_file_adds_only_missing_keys(tmp_path):
    """`-c configs/DINO/DINO_4scale.py` adds only the keys the flags lack,
    as the JAX CLI does: `use_dn` and `modelname` stay the flags' (a
    divergence of the JAX CLI from the reference, mirrored)."""
    args = get_args_parser().parse_args(
        ["-c", os.path.join(os.path.dirname(__file__), "..", "configs", "DINO",
                            "DINO_4scale.py"), "--output_dir", str(tmp_path), "--mp", "2"])
    with pytest.raises(SystemExit, match="--mp"):
        main(args)
    raw = json.load(open(tmp_path / "config_args_raw.json"))
    assert raw["use_dn"] is False and raw["modelname"] == "deformable_detr"
    assert raw["dn_label_noise_ratio"] == 0.5  # a key the flags lack


def test_model_parallelism_names_item_6b(tmp_path):
    with pytest.raises(SystemExit, match=r"--mp > 1 \(ROADMAP Queue 1 item 6b"):
        main(get_args_parser().parse_args(["--output_dir", str(tmp_path), "--mp", "2"]))


@pytest.mark.parametrize("name", ["world_size", "WORLD_SIZE"])
def test_a_multi_process_launch_is_ported(name, monkeypatch):
    """`--world_size` and the like are taken and ignored, as the JAX CLI
    does; WORLD_SIZE alone (no RANK) is one process. Neither exits."""
    argv = ["--world_size", "2", "--rank", "1", "--dist_url", "tcp://h:1"] if name == \
        "world_size" else []
    if name == "WORLD_SIZE":
        monkeypatch.setenv("WORLD_SIZE", "2")
    check_ported(get_args_parser().parse_args(argv))


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


def test_two_stage_without_box_refine_raises_as_the_jax_model_fails(tmp_path):
    argv = ["--output_dir", str(tmp_path), "--device", "cpu", "--two_stage"]
    with pytest.raises(ValueError, match="two_stage=True with with_box_refine=False"):
        main(get_args_parser().parse_args(argv))


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    data = tmp_path_factory.mktemp("data")
    arctic.make_synthetic_root(str(data / "arctic"), num_seqs=1, frames=4, views=2, seed=0,
                               image_hw=(150, 210),
                               obj_bank=objects.synthetic_object_bank(2, device="cpu"))
    return ["--dataset_file", "arctic", "--coco_path", str(data), *TINY, "--img_res", "128",
            "--batch_size", "8", "--val_batch_size", "8", "--debug", "--num_debug", "1",
            "--num_workers", "2", "--epochs", "1"]


#: model and training options the CLI runs, as one `--debug` step and its eval
OPTIONS = {
    "remat_enc_lite": ["--remat", "--enc_lite", "--enc_lite_hi_every", "2", "--enc_layers",
                       "2", "--dropout", "0.1"],
    "sgd_learned_posenc_no_aux": ["--two_stage", "--with_box_refine", "--sgd",
                                  "--position_embedding", "learned", "--no_aux_loss"],
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_the_model_options_train_and_evaluate(name, small_root, tmp_path):
    """Each option that used to exit runs a train step and the epoch's eval;
    its checkpoint resumes into `--eval`."""
    out = tmp_path / "out"
    argv = small_root + OPTIONS[name]
    res = main(get_args_parser().parse_args(argv + ["--output_dir", str(out), "--device",
                                                    "cpu"]))
    epoch = res["epochs"][0]
    assert np.isfinite(epoch["stats"]["loss"]) and epoch["stats"]["grad_norm"] > 0
    assert {"aae", "mpjpe/ra/h"} <= set(epoch["scores"])
    ev = main(get_args_parser().parse_args(argv + [
        "--output_dir", str(tmp_path / "ev"), "--device", "cpu", "--eval", "--resume",
        str(out / "0"), "--eval_metrics", "aae"]))
    assert np.isfinite(ev["scores"][0]["aae"])


@pytest.mark.parametrize("backbone", ["resnet50", "convnext_xlarge_22k"])
def test_dino_trains_a_debug_step_and_its_checkpoint_evaluates(backbone, small_root, tmp_path,
                                                               monkeypatch):
    """`--modelname dino --two_stage` trains one `--debug` step (its loss
    holds the `*_dn` terms through the total) and evaluates; its checkpoint
    resumes into `--eval` with the same scores. The ConvNeXt is shrunken
    (depths 1, dims 16..128) so that it runs here."""
    from uvhand_tpu_torch.models.backbones import convnext

    monkeypatch.setattr(convnext, "CONVNEXT_XL_DEPTHS", (1, 1, 1, 1))
    monkeypatch.setattr(convnext, "CONVNEXT_XL_DIMS", (16, 32, 64, 128))
    argv = small_root + ["--modelname", "dino", "--two_stage", "--dn_number", "2",
                         "--backbone", backbone]
    out = tmp_path / "out"
    res = main(get_args_parser().parse_args(argv + ["--output_dir", str(out), "--device",
                                                    "cpu"]))
    epoch = res["epochs"][0]
    assert np.isfinite(epoch["stats"]["loss"]) and epoch["stats"]["grad_norm"] > 0
    saved = torch.load(out / "0" / "checkpoint.pth", weights_only=False)["model"]
    assert {"label_enc.weight", "transformer.tgt_embed.weight", "class_embed.0.weight"} <= set(
        saved)
    ev = main(get_args_parser().parse_args(argv + [
        "--output_dir", str(tmp_path / "ev"), "--device", "cpu", "--eval", "--resume",
        str(out / "0")]))
    for k, v in epoch["scores"].items():
        assert ev["scores"][0][k] == v or (np.isnan(v) and np.isnan(ev["scores"][0][k])), k


@pytest.mark.parametrize("head,split", [("lstm", []), ("vivit", ["--split_window"])])
def test_arctic_lstm_trains_each_temporal_head_and_resumes(head, split, small_root, tmp_path):
    """`--method arctic_lstm --window_size 3 --temporal_head <head>` trains a
    `--debug` step on windows centred on frames (the centre frames' targets,
    or every frame's with `--split_window`), its loss holding the
    `/temporal` terms through the total, and evaluates; its checkpoint,
    which holds the head, resumes into `--eval` with the same scores."""
    argv = small_root + ["--two_stage", "--with_box_refine", "--method", "arctic_lstm",
                         "--window_size", "3", "--temporal_head", head, *split]
    out = tmp_path / "out"
    res = main(get_args_parser().parse_args(argv + ["--output_dir", str(out), "--device",
                                                    "cpu"]))
    epoch = res["epochs"][0]
    assert np.isfinite(epoch["stats"]["loss"]) and epoch["stats"]["grad_norm"] > 0
    saved = torch.load(out / "0" / "checkpoint.pth", weights_only=False)["model"]
    block = "temporal_param_head.ta_pose_l." + ("bilstm.lstm.weight_hh_l0_reverse"
                                                 if head == "lstm" else "temporal_pos")
    assert block in saved
    ev = main(get_args_parser().parse_args(argv + [
        "--output_dir", str(tmp_path / "ev"), "--device", "cpu", "--eval", "--resume",
        str(out / "0")]))
    for k, v in epoch["scores"].items():
        assert ev["scores"][0][k] == v or (np.isnan(v) and np.isnan(ev["scores"][0][k])), k


def test_train_smoothnet_writes_the_smoother_and_resumes_it(small_root, tmp_path):
    """`--train_smoothnet --window_size 3` trains the smoother a `--debug`
    step behind the frozen base (resumed from `--resume`) and writes it with
    its optimizer each epoch; `--smooth_resume` of that checkpoint starts
    from those weights and that optimizer state."""
    base = small_root + ["--two_stage", "--with_box_refine"]
    main(get_args_parser().parse_args(base + ["--output_dir", str(tmp_path / "base"),
                                              "--device", "cpu"]))
    argv = base + ["--train_smoothnet", "--window_size", "3", "--device", "cpu", "--resume",
                   str(tmp_path / "base" / "0")]
    res = main(get_args_parser().parse_args(argv + ["--output_dir", str(tmp_path / "sm")]))
    (epoch,) = res["smoothnet"]
    assert epoch["steps"] == 1 and np.isfinite(epoch["losses"]["total"])
    assert {"loss/cd", "acc/h", "acc/o", "total"} == set(epoch["losses"])
    saved = torch.load(tmp_path / "sm" / "0" / "checkpoint.pth", weights_only=False)
    assert sorted(saved["model"]) == sorted(
        smoothnet.ArcticSmoother(3).state_dict()) and saved["step"] == 1
    assert saved["optimizer"]["state"]  # AdamW's moments after one step
    loaded = []
    real_load = ckpt.load_checkpoint

    def load(path, model, *args, **kwargs):
        loaded.append((path, type(model).__name__, real_load(path, model, *args, **kwargs)))
        return loaded[-1][2]

    monkey = pytest.MonkeyPatch()
    monkey.setattr(ckpt, "load_checkpoint", load)
    try:
        res = main(get_args_parser().parse_args(argv + [
            "--output_dir", str(tmp_path / "sm2"), "--smooth_resume", str(tmp_path / "sm" / "0")]))
    finally:
        monkey.undo()
    assert [(p, m) for p, m, _ in loaded] == [(str(tmp_path / "base" / "0"), "UVHandDETR"),
                                              (str(tmp_path / "sm" / "0"), "ArcticSmoother")]
    assert loaded[1][2]["optimizer_restored"]
    assert np.isfinite(res["smoothnet"][0]["losses"]["total"])


def test_train_smoothnet_over_processes_exits_naming_it(monkeypatch):
    from uvhand_tpu_torch.cli.main import train_smoothnet
    from uvhand_tpu_torch.train import mesh

    monkeypatch.setattr(mesh, "active", lambda: True)
    with pytest.raises(SystemExit, match="--train_smoothnet runs in one process"):
        train_smoothnet(get_args_parser().parse_args(["--train_smoothnet"]), None, None, None,
                        "cpu")


@pytest.mark.parametrize("flags", [["--temporal_head", "lstm"],
                                   ["--temporal_head", "vivit", "--method", "arctic_lstm"]],
                         ids=["arctic_sf", "window_1"])
def test_a_temporal_head_without_windows_exits_as_the_jax_cli(flags, small_root, tmp_path):
    argv = small_root + ["--output_dir", str(tmp_path), "--two_stage", "--with_box_refine",
                         *flags]
    msg = (r"--temporal_head requires --method arctic_lstm and --window_size > 1 \(the head "
           r"mixes over window frames\)")
    with pytest.raises(SystemExit, match=msg):
        main(get_args_parser().parse_args(argv + ["--device", "cpu"]))
    with pytest.raises(SystemExit, match=msg):
        jax_main(jax_parser().parse_args(argv))


@pytest.mark.parametrize("model", ["single_stage", "bf16_params"])
def test_the_jax_cli_evaluates_the_port_clis_new_checkpoints(model, small_root, tmp_path):
    """The port CLI trains one `--debug` step of the default (single-stage)
    model, or of the two-stage one with bfloat16 parameters (written widened
    to float32); the port CLI and the JAX CLI then evaluate its
    checkpoint.pth in float32 with the default metrics, within the A/B's
    1e-2 mm + 1e-4 relative."""
    flags = [] if model == "single_stage" else ["--two_stage", "--with_box_refine"]
    out = tmp_path / "out"
    train = flags + (["--bf16_params"] if model == "bf16_params" else [])
    res = main(get_args_parser().parse_args(small_root + train + ["--output_dir", str(out),
                                                                  "--device", "cpu"]))
    assert np.isfinite(res["epochs"][0]["stats"]["loss"])
    saved = torch.load(out / "0" / "checkpoint.pth", weights_only=False)
    assert all(v.dtype != torch.bfloat16 for v in saved["model"].values())
    if model == "bf16_params":  # the optimizer's float32 state and step are saved
        assert saved["optimizer"]["param_groups"][0]["sr_step"] == 1
        assert all(v.dtype == torch.float32 for st in saved["optimizer"]["state"].values()
                   for v in st.values() if isinstance(v, torch.Tensor))
    resume = flags + ["--eval", "--resume", str(out / "0" / "checkpoint.pth")]
    main(get_args_parser().parse_args(small_root + resume + [
        "--output_dir", str(tmp_path / "ev"), "--device", "cpu"]))
    jax_main(jax_parser().parse_args(small_root + resume + ["--output_dir",
                                                            str(tmp_path / "jev")]))
    ours, ref = last_scores(tmp_path / "ev" / "results.txt"), last_scores(
        tmp_path / "jev" / "results.txt")
    assert sorted(ours) == sorted(ref) and {"mdev/h", "acc/h", "aae"} <= set(ours)
    for k, v in ref.items():
        if v is None:
            assert ours[k] is None, k
        else:
            assert abs(ours[k] - v) <= 1e-2 + 1e-4 * abs(v), (k, ours[k], v)


def test_bf16_parameter_checkpoint_round_trip(tmp_path):
    """bfloat16 parameters are written as float32 and narrowed back exactly;
    the optimizer's float32 moments and stochastic-rounding step resume."""
    model = UVHandDETR(num_queries=4, num_encoder_layers=1, num_decoder_layers=1, d_model=32,
                       n_heads=4, dim_feedforward=32, param_dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0), device="cpu")
    opt = create_optimizer(model)
    one_update(model, opt)
    path = ckpt.save_checkpoint(str(tmp_path), 0, model, opt, step=1)
    fresh = UVHandDETR(num_queries=4, num_encoder_layers=1, num_decoder_layers=1, d_model=32,
                       n_heads=4, dim_feedforward=32, param_dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(1), device="cpu")
    fresh_opt = create_optimizer(fresh)
    assert ckpt.load_checkpoint(path, fresh, fresh_opt)["optimizer_restored"]
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b), k
    assert fresh_opt.param_groups[0]["sr_step"] == 1
    copies = [[c for g in o.param_groups for c in g["params"]] for o in (opt, fresh_opt)]
    for p, q in zip(*copies):  # the float32 copies hold the state
        assert opt.state[p] and fresh_opt.state[q].keys() == opt.state[p].keys()
        for k, v in opt.state[p].items():
            assert torch.as_tensor(v).dtype == torch.float32
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(fresh_opt.state[q][k]))
