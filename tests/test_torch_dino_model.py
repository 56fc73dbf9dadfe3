"""The port's DINO variant and `use_dn` model against the JAX package's, on
the CPU.

Small models like `tests/test_dino.py`'s (1 encoder and 2 decoder layers,
d=64, 4 heads, 12 queries, `dn_number` 2: 4 groups, 24 dn queries, dropout
0, feature mask 0) at 128x128 (levels 16/8/4/2: a 64x64 image would have a
1x1 level, where the JAX gather form of MSDA is wrong, ROADMAP Queue 3), on
two frames of a synthetic ARCTIC root with random images. Weights are the
port's, drawn from a seed, with random MSDA offset/attention kernels and
random last layers of the keypoint MLPs (the init's zeros would leave the
refinement idle), carried to JAX by `convert_reference_detr(dino=True)`
and back by `state_dict_from_jax` (the round trip must give the same
tensors). One jitted JAX function per model gives the train-mode outputs,
the loss dict and `jax.grad` of the loss under one CDN draw, and the
eval-mode outputs; the port takes JAX's `dn_meta` (which JAX returns in
`out["dn_outputs"]`) injected.

Held: for both models every output (`stacked`, the swapped `interm_outputs`,
`dn_outputs`) within 1e-4 and the loss dict (every `*_dn` key) within
1e-4; for the DINO model the gradients within 1e-3 of each tensor's max
(the backbone's in relative L2 error, as `test_torch_model_options.py`
holds them; `--use_dn` alone shares its criterion and refinement code and
gets no third JAX compile: the suite is near its time limit) and eval mode
without dn. The look-forward-twice control: the same model with it off
must fail the gradient comparison.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvhand_tpu import engine as jengine
from uvhand_tpu.data import arctic
from uvhand_tpu.geometry import mano as jmano
from uvhand_tpu.geometry import objects as jobjects
from uvhand_tpu.models.detr import UVHandDETR as JaxDETR
from uvhand_tpu.train.convert import convert_reference_detr
from uvhand_tpu.train.state import label_params as jax_label_params
from uvhand_tpu_torch import engine
from uvhand_tpu_torch.geometry import mano, objects
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.train.convert import state_dict_from_jax
from uvhand_tpu_torch.train.state import label_params

from test_torch_model_options import GROUP_CODE, assert_close
from test_torch_train import one_torch_thread  # noqa: F401

RES = 128
CFG = dict(num_queries=12, num_encoder_layers=1, num_decoder_layers=2, d_model=64,
           n_heads=4, dim_feedforward=128, dropout=0.0, feature_mask_ratio=0.0,
           two_stage=True, with_box_refine=True, dn_number=2)
VARIANTS = {"dino": dict(dino_variant=True, use_dn=True, look_forward_twice=True),
            "use_dn": dict(use_dn=True, look_forward_twice=True)}


def tree_np(x):
    return jax.tree.map(lambda v: None if v is None else np.asarray(v), x,
                        is_leaf=lambda v: v is None)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("arctic"))
    jbank = jobjects.synthetic_object_bank(2)
    arctic.make_synthetic_root(root, num_seqs=1, frames=2, views=1, obj_bank=jbank)
    ds = arctic.ArcticDataset(root, "p1", "train", aug=False, two_stage=True,
                              kp3d_cano=np.asarray(jbank.kp_bottom), img_res=RES)
    batch = arctic.collate([ds[i] for i in range(2)])
    batch["images"] = np.random.default_rng(3).uniform(
        -2.0, 2.0, batch["images"].shape).astype(np.float32)
    jworld = (jmano.synthetic_mano(0, True), jmano.synthetic_mano(1, False), jbank)
    tworld = (mano.synthetic_mano(0, True, device="cpu"),
              mano.synthetic_mano(1, False, device="cpu"),
              objects.synthetic_object_bank(2, device="cpu"))
    return batch, jworld, tworld


def port_model(variant, **kw):
    """The port's model of `variant`, seeded, with random MSDA kernels and
    keypoint-MLP last layers."""
    port = UVHandDETR(**CFG, **{**VARIANTS[variant], **kw},
                      generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith(("sampling_offsets.weight", "attention_weights.weight",
                              "key_embed.0.layers.2.weight", "key_embed.layers.2.weight")):
                p.copy_(torch.from_numpy(rng.normal(scale=0.05, size=p.shape).astype(np.float32)))
    return port


def jax_variables(port, variant):
    sd = port.state_dict()
    variables = convert_reference_detr(sd, num_decoder_layers=2, num_encoder_layers=1,
                                       n_heads=4, two_stage=True, dino=variant == "dino")
    if variant == "use_dn":  # the JAX converter maps label_enc in its DINO branch only
        variables["params"]["label_enc"] = {"embedding": sd["label_enc.weight"].numpy()}
    return variables


def run_variant(variant, data):
    """The JAX model's train-mode outputs and loss dict under one CDN draw,
    and for the DINO variant also `jax.grad` of the loss and the eval-mode
    outputs, from one jitted function (`jengine.make_loss_fn`'s objective,
    its outputs kept)."""
    batch, jworld, tworld = data
    port = port_model(variant)
    variables = jax_variables(port, variant)
    jmodel = JaxDETR(**CFG, **VARIANTS[variant])
    rng = jax.random.PRNGKey(5)
    dino = variant == "dino"

    def loss_fn(params, batch):
        targets = jax.lax.stop_gradient(jengine.process_targets(batch, *jworld, float(RES)))
        out = jmodel.apply(
            {"params": params}, batch["images"], train=True,
            rngs={"dropout": rng, "feature_mask": jax.random.fold_in(rng, 1),
                  "dn": jax.random.fold_in(rng, 2)},
            dn_targets={"labels": targets["labels"], "keypoints": targets["keypoints"],
                        "target_valid": targets["target_valid"]
                        & (targets["is_valid"][:, None] > 0)})
        total, ld = jengine.arctic_criterion(out, targets, *jworld, img_res=float(RES))
        return total, (ld, out)

    @jax.jit
    def jrun(params, batch):
        if not dino:
            return loss_fn(params, batch)[1], None, None
        (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch)
        return aux, grads, jmodel.apply({"params": params}, batch["images"])

    (ld, jout), grads, jeval = jrun(variables["params"],
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    dn_meta = {k: torch.from_numpy(np.array(v))
               for k, v in jout["dn_outputs"]["dn_meta"].items()}
    return dict(port=port, variables=variables, dn_meta=dn_meta,
                tbatch=engine.to_device(batch, "cpu", engine.TRAIN_KEYS),
                j_ld={k: float(v) for k, v in ld.items()}, jout=tree_np(jout),
                jeval=tree_np(jeval) if dino else None,
                j_grads={k: v.numpy() for k, v in state_dict_from_jax(grads).items()}
                if dino else None)


def port_grads(port, run, tworld, backward=True):
    """The port's loss dict and (with `backward`) raw gradients in train
    mode under the JAX run's injected CDN draw."""
    port.train()
    port.zero_grad()
    loss_fn = engine.make_loss_fn(port, *tworld, img_res=float(RES))
    with torch.set_grad_enabled(backward):
        total, ld = loss_fn(run["tbatch"], None, run["dn_meta"])
    grads = None
    if backward:
        total.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
                 for n, p in port.named_parameters()}
    port.eval()
    return {k: float(v.detach()) for k, v in ld.items()}, grads


@pytest.fixture(scope="module")
def jax_runs(data):
    """Both models' JAX runs, compiled at once in two threads (XLA compiles
    outside the interpreter lock; the suite is near its time limit)."""
    with ThreadPoolExecutor(2) as pool:
        runs = {v: pool.submit(run_variant, v, data) for v in sorted(VARIANTS)}
        return {v: f.result() for v, f in runs.items()}


def port_run(variant, data, jax_runs):
    r = jax_runs[variant]
    port = r["port"]
    port.train()
    with torch.no_grad():
        r["out"] = port(r["tbatch"]["images"], dn_meta=r["dn_meta"])
    port.eval()
    with torch.no_grad():
        r["eval"] = port(r["tbatch"]["images"])
    # gradients are held for the DINO model (JAX's are computed for it only)
    r["t_ld"], r["grads"] = port_grads(port, r, data[2], backward=variant == "dino")
    r["variant"] = variant
    return r


@pytest.fixture(scope="module")
def dino_run(data, jax_runs):
    return port_run("dino", data, jax_runs)


@pytest.fixture(scope="module")
def use_dn_run(data, jax_runs):
    return port_run("use_dn", data, jax_runs)


@pytest.fixture(params=sorted(VARIANTS))
def run(request):
    return request.getfixturevalue(f"{request.param}_run")


def test_weights_round_trip_through_the_jax_converter(run):
    back = state_dict_from_jax(run["variables"])
    sd = run["port"].state_dict()
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    if run["variant"] == "dino":
        assert {"class_embed.1.weight", "transformer.tgt_embed.weight",
                "transformer.decoder.ref_point_head.layers.1.weight",
                "transformer.decoder.norm.weight", "transformer.enc_out_class_embed.weight",
                "transformer.enc_out_obj_key_embed.layers.2.weight",
                "transformer.two_stage_wh_embedding.weight", "label_enc.weight"} <= set(sd)
        assert run["port"].class_embed[0] is run["port"].class_embed[1]
        assert not any(k.startswith("transformer.pos_trans") for k in sd)


def test_train_outputs_match_jax(run):
    jout, out = run["jout"], run["out"]
    assert sorted(out) == sorted(jout)
    for k, ref in jout["stacked"].items():
        assert_close(out["stacked"][k], ref, what=k)
        assert ref.shape[2] == CFG["num_queries"]  # the dn part split off
    for k, ref in jout["interm_outputs"].items():
        assert_close(out["interm_outputs"][k], ref, what=f"interm {k}")
    jdn, dn = jout["dn_outputs"], out["dn_outputs"]
    for k in ("pred_logits", "pred_hand_key", "pred_obj_key"):
        assert jdn[k].shape[2] == 24
        assert_close(dn[k], jdn[k], what=f"dn {k}")
    for k, ref in jdn["dn_meta"].items():
        assert torch.equal(dn["dn_meta"][k], torch.from_numpy(ref)), k


def test_losses_match_jax(run):
    ours, ref = run["t_ld"], run["j_ld"]
    assert set(ours) == set(ref)
    dn_keys = {k for k in ref if "_dn" in k}
    assert dn_keys == {f"{n}{s}" for n in ("loss_ce", "loss_hand_keypoint", "loss_obj_keypoint")
                       for s in ("_dn", "_dn_0")}
    assert all(ref[k] > 0 for k in dn_keys)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)


def gradient_errors(grads, ref, labels):
    """(names outside the backbone whose gradient misses 1e-3 of its max,
    the backbone's relative L2 error)."""
    bad, bb_err, bb_ref = [], 0.0, 0.0
    for name, g in grads.items():
        if labels[name] == "backbone":
            bb_err += float(np.sum((g - ref[name]).astype(np.float64) ** 2))
            bb_ref += float(np.sum(ref[name].astype(np.float64) ** 2))
        elif np.abs(g - ref[name]).max() > 1e-3 * max(np.abs(ref[name]).max(), 1e-30):
            bad.append(name)
    return bad, np.sqrt(bb_err / bb_ref)


def test_gradients_match_jax(dino_run):
    run = dino_run
    labels = label_params(run["port"])
    assert set(run["grads"]) <= set(run["j_grads"])
    bad, bb = gradient_errors(run["grads"], run["j_grads"], labels)
    assert not bad, bad
    assert bb <= 1e-3, bb
    assert np.abs(run["j_grads"]["label_enc.weight"]).max() > 0  # the dn queries train it


def test_look_forward_twice_control_fails(dino_run, data):
    """The same weights with look-forward-twice off give other gradients:
    layer l's keypoint loss no longer reaches layer l-1's refinement."""
    port = port_model("dino", look_forward_twice=False)
    _, grads = port_grads(port, dino_run, data[2])
    bad, _ = gradient_errors(grads, dino_run["j_grads"], label_params(port))
    assert any("key_embed" in n for n in bad), bad


def test_eval_without_dn_matches_jax(dino_run):
    run = dino_run
    assert "dn_outputs" not in run["eval"] and "dn_outputs" not in run["jeval"]
    for k, ref in run["jeval"]["stacked"].items():
        assert_close(run["eval"]["stacked"][k], ref, what=k)


def test_optimizer_groups_equal_jax(run):
    """`ref_point_head`, `label_enc`, `tgt_embed` and the tied heads fall in
    the JAX package's groups (`label_params`)."""
    params = run["variables"]["params"]
    codes = jax.tree.map(lambda label, leaf: np.full(leaf.shape, GROUP_CODE[label], np.float32),
                         jax_label_params(params), params)
    ref = {k: int(v.flatten()[0]) for k, v in state_dict_from_jax(codes).items()}
    ours = label_params(run["port"])
    assert {n: GROUP_CODE[g] for n, g in ours.items()} == {n: ref[n] for n in ours}
    assert ours["label_enc.weight"] == "general"
    if run["variant"] == "dino":
        assert ours["transformer.decoder.ref_point_head.layers.0.weight"] == "general"
        assert ours["transformer.tgt_embed.weight"] == "general"


def test_dino_needs_two_stage_as_jax_does():
    with pytest.raises(ValueError, match="dino_variant=True with two_stage=False"):
        UVHandDETR(**{**CFG, "two_stage": False}, dino_variant=True, device="cpu")
    with pytest.raises(AttributeError):  # the JAX model has no ref_point_head there
        jax.eval_shape(JaxDETR(**{**CFG, "two_stage": False}, dino_variant=True).init,
                       jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)))
    with pytest.raises(ValueError, match="use_dn=True with two_stage=False"):
        UVHandDETR(**{**CFG, "two_stage": False}, use_dn=True, device="cpu")
