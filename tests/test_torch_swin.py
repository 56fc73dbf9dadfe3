"""The port's Swin backbone against the JAX package's, on the CPU.

  - the window helpers (`relative_position_index`, `shifted_window_mask`,
    `window_partition` / `window_reverse`) bit for bit;
  - one `SwinBlock`, unshifted and shifted, on a 14x14 map (padded to two
    windows of 12), 1e-5; on activations whose variance is near the
    LayerNorm's eps, the same block with torch's eps 1e-5 or with the exact
    GELU misses that tolerance (the controls);
  - a narrow Swin (embed 32, depths 2/2/2/2, heads 1/2/4/8, window 12) at
    112x112: stage maps 28, 14, 7 and 4, so it pads, shifts a single padded
    window (stage 2) and merges an odd side (7 -> 4); every output map
    within 1e-4 in float32 and 2e-2 (of each map's max) in bfloat16;
  - stochastic depth: off without `train`; with `train` and the JAX
    module's own masks injected (its `jax.random.bernoulli` draws,
    recorded), equal to JAX's train-mode output; the port's own draws keep
    1 - rate of the samples;
  - a tiny `UVHandDETR(backbone="swin_L_384_22k")` (1+2 layers, d=64, 12
    queries) with the narrow Swin patched in as `swin_l_384` and
    `SWIN_L_CHANNELS` in BOTH packages (test code only; neither package is
    edited), on `test_torch_model_options.py`'s two-stage batch at 128x128:
    the official names, the round trip of the port's state dict through the
    JAX package's `convert_reference_detr` and `convert_swin_checkpoint`
    and back through `state_dict_from_jax`, the eval outputs, every loss
    term, every gradient (1e-3 of each tensor's max) and one AdamW step
    (`test_torch_train.py`'s check), and the optimizer groups;
  - the CLI with `--backbone swin_L_384_22k` (the narrow Swin patched into
    the port, `--device cpu`) trains one `--debug` step of the two-stage
    model on a synthetic ARCTIC root, evaluates, and its checkpoint resumes
    into `--eval` with the same scores.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvhand_tpu import engine as jengine
from uvhand_tpu.models.backbones import swin as jswin
from uvhand_tpu.models.detr import UVHandDETR as JaxDETR
from uvhand_tpu.train.convert import convert_reference_detr
from uvhand_tpu.train.state import create_train_state
from uvhand_tpu_torch import engine
from uvhand_tpu_torch.cli.main import get_args_parser, main
from uvhand_tpu_torch.data import arctic
from uvhand_tpu_torch.geometry import objects
from uvhand_tpu_torch.models.backbones import swin
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.train.convert import state_dict_from_jax
from uvhand_tpu_torch.train.state import create_optimizer, label_params

from test_torch_model_options import CFG, RES, _param_errors, assert_close, data  # noqa: F401
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

NARROW = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), window_size=12)
NARROW_CHANNELS = (64, 128, 256)


def perturbed(module, seed):
    """`module` with weights from a numpy seed: kernels ~ N(0, 1/fan_in),
    LayerNorm scales 1 + N(0, 0.1), biases N(0, 0.1), bias tables N(0, 0.5),
    so every leaf shows."""
    rng = np.random.default_rng(seed)
    draw = lambda p, base, scale: p.copy_(torch.from_numpy(
        (base + rng.normal(scale=scale, size=p.shape)).astype(np.float32)))
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d)):
                draw(mod.weight, 0.0, mod.weight[0].numel() ** -0.5)
            if isinstance(mod, torch.nn.LayerNorm):
                draw(mod.weight, 1.0, 0.1)
            if isinstance(mod, swin.WindowAttention):
                draw(mod.relative_position_bias_table, 0.0, 0.5)
            if isinstance(mod, (torch.nn.LayerNorm, torch.nn.Linear, torch.nn.Conv2d)) and \
                    mod.bias is not None:
                draw(mod.bias, 0.0, 0.1)
    return module.eval()


def jax_params(module: swin.SwinTransformer):
    return jswin.convert_swin_checkpoint(module.state_dict(), depths=module.depths)


def test_window_helpers_equal_jax():
    for ws in (7, 12):
        np.testing.assert_array_equal(swin.relative_position_index(ws),
                                      jswin.relative_position_index(ws))
    for H, W, ws, shift in ((60, 60, 12, 6), (12, 12, 12, 6), (24, 36, 12, 6), (14, 21, 7, 3)):
        np.testing.assert_array_equal(swin.shifted_window_mask(H, W, ws, shift),
                                      jswin.shifted_window_mask(H, W, ws, shift))
    x = np.random.default_rng(0).normal(size=(2, 24, 36, 5)).astype(np.float32)
    wins = swin.window_partition(torch.from_numpy(x), 12)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jswin.window_partition(x, 12)))
    np.testing.assert_array_equal(swin.window_reverse(wins, 12, 24, 36).numpy(), x)


def block_case(shift, scale=1.0, seed=0):
    """A port block (dim 32, 2 heads, window 12) with perturbed weights, its
    JAX parameters, a 14x14 input scaled by `scale` and JAX's output."""
    block = swin.SwinBlock(32, 2, 12, shift)
    perturbed(block, seed)
    sd = {k: v.numpy() for k, v in block.state_dict().items()}
    lin = lambda n: {"kernel": sd[f"{n}.weight"].T, "bias": sd[f"{n}.bias"]}
    ln = lambda n: {"scale": sd[f"{n}.weight"], "bias": sd[f"{n}.bias"]}
    params = {"norm1": ln("norm1"), "norm2": ln("norm2"), "fc1": lin("mlp.fc1"),
              "fc2": lin("mlp.fc2"),
              "attn": {"qkv": lin("attn.qkv"), "proj": lin("attn.proj"),
                       "relative_position_bias_table": sd["attn.relative_position_bias_table"]}}
    x = (np.random.default_rng(seed + 1).normal(size=(2, 14 * 14, 32)) * scale).astype(np.float32)
    jblock = jswin.SwinBlock(32, 2, 12, shift)
    ref = jax.jit(lambda p, x: jblock.apply({"params": p}, x, 14, 14, False))(params, x)
    return block, x, np.asarray(ref)


@pytest.mark.parametrize("shift", [0, 6], ids=["unshifted", "shifted"])
def test_block_equals_jax(shift):
    block, x, ref = block_case(shift)
    with torch.no_grad():
        out = block(torch.from_numpy(x), 14, 14)
    assert not np.allclose(out.numpy(), x, atol=1e-2)  # the branches show
    assert_close(out, ref, 1e-5, f"block shift {shift}")


def test_block_eps_and_gelu_controls_fail():
    """On activations of variance ~1e-6, near the LayerNorm's eps, the
    block holds to 1e-5; torch's default eps 1e-5 or the exact GELU misses."""
    block, x, ref = block_case(6, scale=1e-3, seed=3)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        assert_close(block(xt, 14, 14), ref, 1e-5, "eps 1e-6, tanh GELU")
        for ln in (block.norm1, block.norm2):
            ln.eps = 1e-5
        with pytest.raises(AssertionError):
            assert_close(block(xt, 14, 14), ref, 1e-5, "eps 1e-5")
        for ln in (block.norm1, block.norm2):
            ln.eps = 1e-6
        gelu = swin.F.gelu
        try:
            swin.F.gelu = lambda y, approximate="none": gelu(y)
            with pytest.raises(AssertionError):
                assert_close(block(xt, 14, 14), ref, 1e-5, "exact GELU")
        finally:
            swin.F.gelu = gelu


@pytest.fixture(scope="module")
def narrow():
    """The narrow Swin in both packages (stochastic depth 0.5), its
    float32 and bfloat16 eval maps, and JAX's train-mode maps with the
    masks JAX drew."""
    port = perturbed(swin.SwinTransformer(**NARROW, drop_path_rate=0.5), 0)
    params = jax_params(port)
    images = np.random.default_rng(1).uniform(-2, 2, (4, 112, 112, 3)).astype(np.float32)
    run = {}
    for name, dtype in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        jmod = jswin.SwinTransformer(**NARROW, drop_path_rate=0.5, dtype=dtype)
        run[name] = jax.jit(jmod.apply)(params, images)
    drawn = []
    bernoulli = jax.random.bernoulli

    def recorded(*a, **kw):  # JAX's draws, returned from the program
        drawn.append(bernoulli(*a, **kw))
        return drawn[-1]

    jmod = jswin.SwinTransformer(**NARROW, drop_path_rate=0.5)

    def train(params, images):
        out = jmod.apply(params, images, train=True, rngs={"dropout": jax.random.PRNGKey(5)})
        return out, list(drawn)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", recorded)
        run["train"], drawn = jax.jit(train)(params, images)
    drawn = [np.array(m).reshape(-1) for m in drawn]
    return dict(port=port, images=images, drawn=drawn, **run)


def nchw(images):
    return torch.from_numpy(images).permute(0, 3, 1, 2)


def test_narrow_swin_maps_equal_jax(narrow):
    port = narrow["port"]
    assert port.channels == NARROW_CHANNELS
    with torch.no_grad():
        maps = port(nchw(narrow["images"]))
    assert [tuple(m.shape[2:]) for m in maps] == [(14, 14), (7, 7), (4, 4)]
    for i, (ours, ref) in enumerate(zip(maps, narrow["fp32"])):
        assert_close(ours.permute(0, 2, 3, 1), ref, 1e-4, f"fp32 map {i}")
    bf16 = swin.SwinTransformer(**NARROW, dtype=torch.bfloat16)
    bf16.load_state_dict(port.state_dict())
    with torch.no_grad():
        maps = bf16(nchw(narrow["images"]))
    for i, (ours, ref) in enumerate(zip(maps, narrow["bf16"])):
        assert ours.dtype == torch.bfloat16
        assert_close(ours.permute(0, 2, 3, 1), np.asarray(ref, np.float32), 2e-2,
                     f"bf16 map {i}")


def test_stochastic_depth_with_jax_masks_equals_jax(narrow):
    port, drawn = narrow["port"], narrow["drawn"]
    rates = port.drop_path_rates
    assert rates[0] == 0 and len(drawn) == 2 * sum(r > 0 for r in rates)
    masks, it = [], iter(drawn)
    for rate in rates:
        masks.append((None, None) if rate <= 0
                     else (torch.from_numpy(next(it)), torch.from_numpy(next(it))))
    assert 0 < sum(int((~m).sum()) for pair in masks if pair[0] is not None for m in pair)
    x = nchw(narrow["images"])
    with torch.no_grad():
        train = port(x, train=True, drop_masks=masks)
        evals = port(x, generator=torch.Generator().manual_seed(0))  # no train: no draws
    for i, (ours, ref, ev) in enumerate(zip(train, narrow["train"], narrow["fp32"])):
        assert_close(ours.permute(0, 2, 3, 1), ref, 1e-4, f"train map {i}")
        assert not np.allclose(np.asarray(ref), np.asarray(ev), atol=1e-3)
    for ours, ref in zip(evals, narrow["fp32"]):
        assert_close(ours.permute(0, 2, 3, 1), ref, 1e-4, "eval")
    with pytest.raises(ValueError, match="generator"):
        port(x, train=True)


def test_stochastic_depth_draws_keep_one_minus_rate():
    port = swin.SwinTransformer(**NARROW, drop_path_rate=0.4)
    masks = port.drop_path_masks(20000, torch.Generator().manual_seed(0))
    assert masks[0] == (None, None)
    for rate, (m1, m2) in zip(port.drop_path_rates[1:], masks[1:]):
        for m in (m1, m2):
            assert abs(float(m.float().mean()) - (1 - rate)) < 4 * np.sqrt(rate * (1 - rate)
                                                                           / 20000)
        assert not torch.equal(m1, m2)


@pytest.fixture(scope="module")
def swin_detr(data):  # noqa: F811
    """The tiny Swin DETR in both packages from the port's seeded weights:
    eval outputs, loss dicts, raw gradients and one AdamW step."""
    batches, jworld, tworld = data
    batch = batches[True]
    with pytest.MonkeyPatch.context() as mp:
        narrow_l = classmethod(lambda cls, **kw: cls(**NARROW, **kw))
        for mod in (jswin, swin):
            mp.setattr(mod.SwinTransformer, "swin_l_384", narrow_l)
            mp.setattr(mod, "SWIN_L_CHANNELS", NARROW_CHANNELS)
        kw = dict(**CFG, backbone="swin_L_384_22k")
        port = UVHandDETR(**kw, generator=torch.Generator().manual_seed(0), device="cpu")
        perturbed(port.body, 4)
        rng = np.random.default_rng(2)
        with torch.no_grad():
            for name, p in port.named_parameters():
                if name.endswith(("sampling_offsets.weight", "attention_weights.weight")):
                    p.copy_(torch.from_numpy(rng.normal(scale=0.05, size=p.shape)
                                             .astype(np.float32)))
        sd = {k: v.clone() for k, v in port.state_dict().items()}
        variables = convert_reference_detr(sd, num_decoder_layers=2, num_encoder_layers=1,
                                           n_heads=4, num_feature_levels=4)
        variables["params"]["backbone"] = jswin.convert_swin_checkpoint(
            {k[len("backbone.0."):]: v for k, v in sd.items() if k.startswith("backbone.0.")},
            depths=NARROW["depths"])["params"]
        jmodel = JaxDETR(**kw)
        state = create_train_state(jmodel, variables, lr=2e-4, lr_backbone=2e-5,
                                   clip_max_norm=0.1)
        loss_fn = jengine.make_loss_fn(jmodel, *jworld, img_res=float(RES))

        @jax.jit
        def jstep(state, batch):
            (_, ld), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params, batch, jax.random.PRNGKey(0))
            ld["grad_norm"] = jengine.global_norm(grads)
            out = jmodel.apply({"params": state.params}, batch["images"])
            return state.apply_gradients(grads=grads), ld, grads, out

        state, ld, grads, jout = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        with torch.no_grad():
            out = port(torch.from_numpy(batch["images"]))
        port.train()
        total, _ = engine.make_loss_fn(port, *tworld, img_res=float(RES))(
            engine.to_device(batch, "cpu", engine.TRAIN_KEYS), None)
        total.backward()
        raw = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
               for n, p in port.named_parameters()}
        step = engine.make_fused_train_step(port, *tworld, create_optimizer(port),
                                            img_res=float(RES), device="cpu")
        t_ld = {k: float(v) for k, v in step(batch).items()}
    return dict(sd=sd, variables=variables, jout=jout, out=out, raw=raw, t_ld=t_ld,
                j_ld={k: float(v) for k, v in ld.items()}, labels=label_params(port),
                j_grads=[{k: v.numpy() for k, v in state_dict_from_jax(grads).items()}],
                j_params=[{k: v.numpy() for k, v in state_dict_from_jax(state.params).items()}],
                t_params=[{n: p.detach().numpy().copy() for n, p in port.named_parameters()}])


def test_swin_names_round_trip_through_the_jax_converters(swin_detr):
    sd = swin_detr["sd"]
    assert {"backbone.0.patch_embed.proj.weight", "backbone.0.patch_embed.norm.bias",
            "backbone.0.layers.0.blocks.1.attn.relative_position_bias_table",
            "backbone.0.layers.2.blocks.0.attn.qkv.weight", "backbone.0.layers.1.blocks.1.mlp.fc2.bias",
            "backbone.0.layers.2.downsample.reduction.weight", "backbone.0.norm3.weight"} <= set(sd)
    assert not any("relative_position_index" in k or "layers.3.downsample" in k for k in sd)
    back = state_dict_from_jax(swin_detr["variables"])
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_swin_detr_outputs_equal_jax(swin_detr):
    out, jout = swin_detr["out"], swin_detr["jout"]
    for k, ref in jout["stacked"].items():
        assert_close(out["stacked"][k], ref, what=k)
    for k, ref in jout["interm_outputs"].items():
        assert_close(out["interm_outputs"][k], ref, what=f"interm {k}")


def test_swin_detr_losses_and_gradients_equal_jax(swin_detr):
    ours, ref = swin_detr["t_ld"], swin_detr["j_ld"]
    assert set(ours) == set(ref)
    for k in ref:
        rtol = 1e-3 if k == "grad_norm" else 1e-4
        np.testing.assert_allclose(ours[k], ref[k], rtol=rtol, atol=1e-6, err_msg=k)
    grads = swin_detr["j_grads"][0]
    assert set(swin_detr["raw"]) <= set(grads)
    for name, g in swin_detr["raw"].items():
        np.testing.assert_allclose(g, grads[name], rtol=0,
                                   atol=1e-3 * max(np.abs(grads[name]).max(), 1e-30),
                                   err_msg=name)
    assert np.abs(grads["backbone.0.layers.0.blocks.0.attn.relative_position_bias_table"]).max() > 0


def test_swin_detr_adamw_step_equals_jax(swin_detr):
    errs, counts = _param_errors(swin_detr, 1)
    for group in counts:
        assert errs[group].max() <= 2e-2, (group, errs[group].max(), counts)
    labels = swin_detr["labels"]
    assert {labels[n] for n in labels if n.startswith("backbone.0.")} == {"backbone"}


def test_cli_trains_and_resumes_the_swin_backbone(tmp_path, monkeypatch):
    monkeypatch.setattr(swin.SwinTransformer, "swin_l_384",
                        classmethod(lambda cls, **kw: cls(**NARROW, **kw)))
    monkeypatch.setattr(swin, "SWIN_L_CHANNELS", NARROW_CHANNELS)
    arctic.make_synthetic_root(str(tmp_path / "data" / "arctic"), num_seqs=1, frames=4, views=2,
                               seed=0, image_hw=(150, 210),
                               obj_bank=objects.synthetic_object_bank(2, device="cpu"))
    argv = ["--dataset_file", "arctic", "--coco_path", str(tmp_path / "data"), "--device", "cpu",
            "--enc_layers", "1", "--dec_layers", "1", "--hidden_dim", "64", "--dim_feedforward",
            "64", "--nheads", "4", "--num_queries", "12", "--img_res", "128", "--batch_size", "8",
            "--val_batch_size", "8", "--debug", "--num_debug", "1", "--num_workers", "2",
            "--epochs", "1", "--two_stage", "--with_box_refine", "--backbone", "swin_L_384_22k"]
    out = tmp_path / "out"
    res = main(get_args_parser().parse_args(argv + ["--output_dir", str(out)]))
    epoch = res["epochs"][0]
    assert np.isfinite(epoch["stats"]["loss"]) and epoch["stats"]["grad_norm"] > 0
    saved = torch.load(out / "0" / "checkpoint.pth", weights_only=False)["model"]
    assert "backbone.0.layers.2.blocks.1.attn.relative_position_bias_table" in saved
    ev = main(get_args_parser().parse_args(argv + [
        "--output_dir", str(tmp_path / "ev"), "--eval", "--resume", str(out / "0")]))
    for k, v in epoch["scores"].items():
        assert ev["scores"][0][k] == v or (np.isnan(v) and np.isnan(ev["scores"][0][k])), k
