"""The port's model options against the JAX package's, on the CPU.

Small models like `tests/test_config_variants.py`'s (1 encoder and 2
decoder layers, d=64, 4 heads, 12 queries, dropout 0, feature mask 0) at
128x128 (levels 16/8/4/2: a 64x64 image would have a 1x1 level, where the
JAX gather form is wrong, ROADMAP Queue 3). Weights are the JAX model's
initialisation, the MSDA offset and attention kernels drawn from a numpy
seed (their init is zero, which would leave the queries unread), carried
to the port by `state_dict_from_jax`; the training run takes the port's
seeded weights instead, carried to JAX by `convert_reference_detr` and
back, as `test_torch_train.py` does:

  - the single-stage model without box refinement (BASELINE config 1, the
    CLI's default): the forward's `stacked` outputs, every loss term of
    JAX's `arctic_criterion(two_stage=False)` against the port's criterion
    (which reads the single-stage model from its outputs) and one AdamW
    step of `make_fused_train_step`, on `test_torch_train.py`'s batch read
    with `two_stage=False` targets;
  - the single-stage model with a class head per layer: its forward; the
    two-stage model without box refinement raises, as the JAX model fails;
  - the learned position encoding: the encoding itself, then a two-stage
    model with it and `aux_loss=False`: forward, output keys and the loss
    dict against JAX's, and every parameter's optimizer group.

Tolerances: 1e-4 on float32 outputs and loss terms, 1e-3 of each tensor's
max on gradients (the JAX suite's), parameters after one step within 2e-2
lr off the noise floor (`tests/test_torch_train.py`'s check).
"""

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
from uvhand_tpu.models.posenc import LearnedPositionEncoding as JaxLearned
from uvhand_tpu.train.convert import convert_reference_detr
from uvhand_tpu.train.state import create_train_state
from uvhand_tpu.train.state import label_params as jax_label_params
from uvhand_tpu_torch import engine
from uvhand_tpu_torch.geometry import mano, objects
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.models.posenc import LearnedPositionEncoding
from uvhand_tpu_torch.train.convert import state_dict_from_jax
from uvhand_tpu_torch.train.state import create_optimizer, label_params

from test_torch_train import _param_errors, one_torch_thread  # noqa: F401

RES = 128
CFG = dict(num_queries=12, num_encoder_layers=1, num_decoder_layers=2, d_model=64,
           n_heads=4, dim_feedforward=128, dropout=0.0, feature_mask_ratio=0.0)
GROUP_CODE = {"general": 0, "backbone": 1, "linear_proj": 2}
#: the training run's MSDA kernels: with seed 1 one decoder FFN unit's input
#: lies within 1e-6 of ReLU's kink, where the last bits (even torch's thread
#: count) decide whether it passes a gradient
KERNEL_SEED = 2


def jax_variables(jmodel, images, seed=1):
    """The JAX model's init, its MSDA offset/attention kernels ~ N(0, 0.05)."""
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(images))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        keys = [str(getattr(p, "key", p)) for p in path]
        if keys[-1] == "kernel" and keys[-2] in ("sampling_offsets", "attention_weights"):
            return jnp.asarray(rng.normal(scale=0.05, size=leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, variables)


def port_of(variables, **kw):
    """The port's model of `CFG` (`kw` overriding it) with `variables`."""
    port = UVHandDETR(**{**CFG, **kw}, device="cpu")
    sd = state_dict_from_jax(variables)
    assert sorted(sd) == sorted(port.state_dict())  # the same leaves, no more
    port.load_state_dict(sd)
    return port


def assert_close(ours, ref, tol=1e-4, what=""):
    ours = ours.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def assert_stacked_match(jout, out):
    for k, ref in jout["stacked"].items():
        if ref is None:
            assert out["stacked"][k] is None, k
        else:
            assert_close(out["stacked"][k], ref, what=k)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """`test_torch_train.py`'s batch with the single-stage targets (no
    keypoints), and both packages' synthetic MANO and object bank."""
    root = str(tmp_path_factory.mktemp("arctic"))
    jbank = jobjects.synthetic_object_bank(2)
    arctic.make_synthetic_root(root, num_seqs=1, frames=4, views=1, obj_bank=jbank)
    batch = {}
    for two_stage in (False, True):
        ds = arctic.ArcticDataset(root, "p1", "train", aug=False, two_stage=two_stage,
                                  kp3d_cano=np.asarray(jbank.kp_bottom), img_res=RES)
        batch[two_stage] = arctic.collate([ds[i] for i in range(4)])
    assert not batch[False]["keypoints"].any() and batch[True]["keypoints"].any()
    jworld = (jmano.synthetic_mano(0, True), jmano.synthetic_mano(1, False), jbank)
    tworld = (mano.synthetic_mano(0, True, device="cpu"),
              mano.synthetic_mano(1, False, device="cpu"),
              objects.synthetic_object_bank(2, device="cpu"))
    return batch, jworld, tworld


@pytest.fixture(scope="module")
def single_stage(data):
    """Config 1: forward, losses, raw gradients and one AdamW step in both."""
    batches, jworld, tworld = data
    # images from a numpy seed: the synthetic frames' flat backgrounds tie
    # the random ResNet-50's max-pools, whose gradient torch and XLA route
    # to different elements
    batch = dict(batches[False], images=np.random.default_rng(3).uniform(
        -2.0, 2.0, batches[False]["images"].shape).astype(np.float32))
    jmodel = JaxDETR(**CFG, two_stage=False, with_box_refine=False)
    # the port's seeded weights (as test_torch_train.py's: a random ResNet of
    # the JAX init ties in its max-pool, whose gradient then goes elsewhere)
    port = UVHandDETR(**CFG, two_stage=False, with_box_refine=False,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(KERNEL_SEED)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith(("sampling_offsets.weight", "attention_weights.weight")):
                p.copy_(torch.from_numpy(rng.normal(scale=0.05, size=p.shape).astype(np.float32)))
    variables = convert_reference_detr(port.state_dict(), num_decoder_layers=2,
                                       num_encoder_layers=1, n_heads=4, two_stage=False)
    back = state_dict_from_jax(variables)  # and back: the single-stage leaves map both ways
    assert all(torch.equal(back[k], v) for k, v in port.state_dict().items())
    state = create_train_state(jmodel, variables, lr=2e-4, lr_backbone=2e-5, clip_max_norm=0.1)
    loss_fn = jengine.make_loss_fn(jmodel, *jworld, img_res=float(RES), two_stage=False)

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
    return dict(jout=jout, out=out, j_ld={k: float(v) for k, v in ld.items()}, t_ld=t_ld,
                raw=raw, labels=label_params(port),
                j_grads=[{k: v.numpy() for k, v in state_dict_from_jax(grads).items()}],
                j_params=[{k: v.numpy() for k, v in state_dict_from_jax(state.params).items()}],
                t_params=[{n: p.detach().numpy().copy() for n, p in port.named_parameters()}])


def test_single_stage_forward_matches_jax(single_stage):
    jout, out = single_stage["jout"], single_stage["out"]
    assert sorted(out) == sorted(jout) and "interm_outputs" not in out
    assert out["stacked"]["pred_hand_key"] is None and out["pred_obj_key"] is None
    assert_stacked_match(jout, out)


def test_single_stage_losses_match_jax(single_stage):
    ours, ref = single_stage["t_ld"], single_stage["j_ld"]
    assert set(ours) == set(ref)
    assert not any("keypoint" in k or "interm" in k for k in ref)
    for k in ref:
        # grad_norm is a gradient's: 1e-3 (the backbone's dominate it)
        rtol = 1e-3 if k == "grad_norm" else 1e-4
        np.testing.assert_allclose(ours[k], ref[k], rtol=rtol, atol=1e-6, err_msg=k)


def test_single_stage_gradients_match_jax(single_stage):
    """Every gradient outside the backbone within 1e-3 of its tensor's max;
    the backbone's within 1e-3 in relative L2 error: in the random
    ResNet-50 a unit whose input lies within float32 noise of a ReLU kink
    or a max-pool tie passes its gradient in one package and not the
    other, which moves single elements by their whole size (a handful of
    its 23.5M elements; the norm of the error stays ~1e-4)."""
    ref = single_stage["j_grads"][0]
    assert set(single_stage["raw"]) <= set(ref)
    bb_err, bb_ref = 0.0, 0.0
    for name, g in single_stage["raw"].items():
        group = single_stage["labels"][name]
        if group == "backbone":
            bb_err += float(np.sum((g - ref[name]).astype(np.float64) ** 2))
            bb_ref += float(np.sum(ref[name].astype(np.float64) ** 2))
            continue
        np.testing.assert_allclose(g, ref[name], rtol=0,
                                   atol=1e-3 * max(np.abs(ref[name]).max(), 1e-30), err_msg=name)
    assert np.sqrt(bb_err / bb_ref) <= 1e-3, np.sqrt(bb_err / bb_ref)
    # the learned queries and the reference-point head train
    assert np.abs(ref["query_embed.weight"]).max() > 0
    assert np.abs(ref["transformer.reference_points.weight"]).max() > 0


def test_single_stage_adamw_step_matches_jax(single_stage):
    """Outside the backbone (whose few kink-flipped gradients step the
    other way), `test_torch_train.py`'s one-step check."""
    errs, counts = _param_errors(single_stage, 1)
    del counts["backbone"]
    masked = sum(m for m, _ in counts.values()) / sum(n for _, n in counts.values())
    assert masked < 0.4, counts
    for group in counts:
        assert errs[group].max() <= 2e-2, (group, errs[group].max(), counts)


def test_single_stage_with_a_class_head_per_layer_matches_jax(data):
    images = data[0][False]["images"][:2]
    jmodel = JaxDETR(**CFG, two_stage=False, with_box_refine=True)
    variables = jax_variables(jmodel, images)
    assert {"cls_head0", "cls_head1"} <= set(variables["params"]["transformer"])
    port = port_of(variables, two_stage=False, with_box_refine=True)
    assert port.cls_embed[0] is not port.cls_embed[1] and port.key_embed is None
    with torch.no_grad():
        out = port(torch.from_numpy(images))
    assert_stacked_match(jax.jit(jmodel.apply)(variables, jnp.asarray(images)), out)


def test_two_stage_without_box_refine_raises_as_jax_fails():
    with pytest.raises(ValueError, match="two_stage=True with with_box_refine=False"):
        UVHandDETR(**CFG, two_stage=True, with_box_refine=False, device="cpu")
    with pytest.raises(TypeError):  # the JAX model indexes its missing key heads
        jax.eval_shape(JaxDETR(**CFG, two_stage=True, with_box_refine=False).init,
                       jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)))


def test_learned_position_encoding_matches_jax():
    mask = np.zeros((2, 9, 13), bool)
    mask[1, :, 10:] = True
    ref_mod = JaxLearned(num_pos_feats=32)
    params = ref_mod.init(jax.random.PRNGKey(3), jnp.asarray(mask))
    ref = ref_mod.apply(params, jnp.asarray(mask))
    ours = LearnedPositionEncoding(32)
    with torch.no_grad():
        for name in ("row_embed", "col_embed"):
            getattr(ours, name).weight.copy_(torch.from_numpy(
                np.array(params["params"][name])))
    out = ours(torch.from_numpy(mask))
    assert out.shape == (2, 9, 13, 64)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    ours.reset_parameters(torch.Generator().manual_seed(0))  # uniform(0, 1), as JAX's init
    w = ours.row_embed.weight.detach()
    assert 0.0 <= float(w.min()) and float(w.max()) < 1.0 and 0.4 < float(w.mean()) < 0.6


@pytest.fixture(scope="module")
def learned_no_aux(data):
    batches, jworld, tworld = data
    batch = batches[True]
    kw = dict(position_embedding="learned", aux_loss=False)
    jmodel = JaxDETR(**CFG, **kw)
    variables = jax_variables(jmodel, batch["images"][:1])
    port = port_of(variables, **kw)
    loss_fn = jengine.make_loss_fn(jmodel, *jworld, img_res=float(RES))

    @jax.jit
    def jrun(variables, batch):
        _, ld = loss_fn(variables["params"], batch, jax.random.PRNGKey(0))
        return jmodel.apply(variables, batch["images"]), ld

    jout, j_ld = jrun(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        out = port(torch.from_numpy(batch["images"]))
        _, t_ld = engine.make_loss_fn(port, *tworld, img_res=float(RES))(
            engine.to_device(batch, "cpu", engine.TRAIN_KEYS), None)
    return dict(variables=variables, port=port, jout=jout, out=out,
                j_ld={k: float(v) for k, v in j_ld.items()},
                t_ld={k: float(v) for k, v in t_ld.items()})


def test_learned_position_encoding_model_matches_jax(learned_no_aux):
    run = learned_no_aux
    assert {"backbone.1.row_embed.weight", "backbone.1.col_embed.weight"} <= set(
        run["port"].state_dict())
    assert_stacked_match(run["jout"], run["out"])
    for k, ref in run["jout"]["interm_outputs"].items():
        assert_close(run["out"]["interm_outputs"][k], ref, what=f"interm {k}")


def test_no_aux_outputs_and_losses_equal_jax(learned_no_aux):
    """`aux_loss=False` drops the `aux_outputs` key only: the loss dict still
    has every layer's terms, as in the JAX package."""
    run = learned_no_aux
    assert "aux_outputs" not in run["out"] and sorted(run["out"]) == sorted(run["jout"])
    ours, ref = run["t_ld"], run["j_ld"]
    assert set(ours) == set(ref) and {"loss_ce_0", "loss_hand_keypoint_0"} <= set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_optimizer_groups_equal_jax(learned_no_aux):
    """Every parameter's group equals JAX's `label_params`; the learned
    position embedding (`backbone.1.*` here, `pos_embed/*` there) is in the
    general group, not the backbone's."""
    params = learned_no_aux["variables"]["params"]
    codes = jax.tree.map(lambda label, leaf: np.full(leaf.shape, GROUP_CODE[label], np.float32),
                         jax_label_params(params), params)
    ref = {k: int(v.flatten()[0]) for k, v in state_dict_from_jax(codes).items()}
    ours = label_params(learned_no_aux["port"])
    assert set(ours) <= set(ref)
    assert {n: GROUP_CODE[g] for n, g in ours.items()} == {n: ref[n] for n in ours}
    assert ours["backbone.1.row_embed.weight"] == "general"

