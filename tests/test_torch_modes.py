"""The port's model and training modes against the JAX package's, on the CPU.

  - enc_lite (hi_every 2, 3 encoder layers: layer 0 refines the
    low-resolution tokens only): the encoder memory, the outputs and the
    gradient of the low-resolution-only layer against JAX; its parameter
    names and shapes are the dense model's;
  - remat, with dropout 0.1 and the feature mask on: the loss and every
    gradient equal the run without remat from the same weights and seeded
    generator, the generator ends where it did, and one fused step moves
    the parameters the same way;
  - SGD: three steps of the port's optimizer equal optax's
    `clip_by_global_norm` + `add_decayed_weights` + `sgd(momentum=0.9)`
    per group on the same gradients;
  - stochastic rounding: given `jax.random.bits(key, shape, uint16)`, the
    port's `stochastic_round_bf16` equals `stochastic_round_bf16(x, key)`
    bit for bit; with its own draws it is unbiased;
  - bfloat16 parameters: `StochasticRounding` (AdamW and SGD) takes two
    steps on the same gradients with JAX's per-leaf draws injected as
    `SRTrainState.apply_gradients` does; an encoder and a decoder layer and
    the single-stage model in the bf16 compute mode with bf16 parameters
    against JAX's, and one fused train step's losses against JAX's.

Models as in `test_torch_model_options.py` (d=64, 4 heads, 12 queries,
128x128). Tolerances: 1e-4 on float32 outputs, 1e-3 of each tensor's max on
float32 gradients, bf16 scale (a few 2^-8 steps) where bf16 computes, and
no tolerance where the arithmetic is the same (remat, SR).
"""

import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from uvhand_tpu import engine as jengine
from uvhand_tpu.data import arctic as jarctic
from uvhand_tpu.geometry import mano as jmano
from uvhand_tpu.geometry import objects as jobjects
from uvhand_tpu.models.detr import UVHandDETR as JaxDETR
from uvhand_tpu.models.transformer import DecoderLayer as JaxDecoderLayer
from uvhand_tpu.models.transformer import EncoderLayer as JaxEncoderLayer
from uvhand_tpu.train.state import create_optimizer as jax_create_optimizer
from uvhand_tpu.train.state import create_train_state
from uvhand_tpu.train.state import stochastic_round_bf16 as jax_sr
from uvhand_tpu_torch import engine
from uvhand_tpu_torch.data import arctic
from uvhand_tpu_torch.geometry import mano, objects
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.models.transformer import EncoderLayer
from uvhand_tpu_torch.train.convert import state_dict_from_jax
from uvhand_tpu_torch.train.state import (StochasticRounding, clip_by_global_norm_,
                                          create_optimizer, global_norm,
                                          stochastic_round_bf16)

from test_torch_model_options import CFG, RES, jax_variables, port_of
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

LEVELS = ((16, 16), (8, 8), (4, 4), (2, 2))  # a 128x128 image


def _rel(ours, ref):
    ours = ours.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


def images(seed=0, n=2):
    return np.random.default_rng(seed).uniform(-2, 2, (n, RES, RES, 3)).astype(np.float32)


# ---------------------------------------------------------------- enc_lite

LITE = dict(CFG, num_encoder_layers=3, enc_lite=True, enc_lite_hi_every=2)


@pytest.fixture(scope="module")
def lite():
    img = images(0)
    jmodel = JaxDETR(**LITE)
    variables = jax_variables(jmodel, img[:1])
    port = port_of(variables, **LITE)
    # a fixed linear function of every output, and its gradient
    wrng = np.random.default_rng(7)
    heads = ("pred_logits", "pred_hand_key", "pred_mano_pose", "pred_obj_cam")
    shapes = {k: np.asarray(v).shape for k, v in jax.eval_shape(
        jmodel.apply, variables, jnp.asarray(img))["stacked"].items() if k in heads}
    weights = {k: wrng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}

    def objective(params):
        out, inter = jmodel.apply({"params": params}, jnp.asarray(img),
                                  capture_intermediates=lambda m, _: m.name == "transformer",
                                  mutable=["intermediates"])
        f = sum(jnp.sum(out["stacked"][k] * weights[k]) for k in heads)
        return f, (out, inter["intermediates"]["transformer"]["__call__"][0]["memory"])

    (_, (jout, jmem)), jgrads = jax.jit(jax.value_and_grad(objective, has_aux=True))(
        variables["params"])
    captured = {}
    port.transformer.register_forward_hook(lambda m, a, o: captured.update(memory=o["memory"]))
    out = port(torch.from_numpy(img))
    sum((out["stacked"][k] * torch.from_numpy(weights[k])).sum() for k in heads).backward()
    return dict(port=port, jout=jout, jmem=jmem, out=out, memory=captured["memory"],
                jgrads=state_dict_from_jax(jgrads))


def test_enc_lite_memory_and_outputs_match_jax(lite):
    assert _rel(lite["memory"], lite["jmem"]) <= 1e-4
    for k, ref in lite["jout"]["stacked"].items():
        assert _rel(lite["out"]["stacked"][k], ref) <= 1e-4, k
    for k, ref in lite["jout"]["interm_outputs"].items():
        assert _rel(lite["out"]["interm_outputs"][k], ref) <= 1e-4, k


def test_enc_lite_low_resolution_layer_gradient_matches_jax(lite):
    names = [n for n, _ in lite["port"].named_parameters()
             if n.startswith("transformer.encoder.layers.0.")]
    assert len(names) == 16
    for n in names:
        p = dict(lite["port"].named_parameters())[n]
        ref = lite["jgrads"][n].numpy()
        assert np.abs(ref).max() > 0, n
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max(), err_msg=n)


def test_enc_lite_keeps_the_dense_parameters(lite):
    dense = UVHandDETR(**dict(LITE, enc_lite=False), device="cpu")
    assert {k: v.shape for k, v in lite["port"].state_dict().items()} == {
        k: v.shape for k, v in dense.state_dict().items()}


def test_encoder_layer_samples_the_given_value():
    """`value=None` is self-attention; `value=src` is the same call."""
    layer = EncoderLayer(32, 64, 2, 4, 2, dropout=0.0)
    rng = np.random.default_rng(0)
    shapes = ((4, 4), (2, 2))
    src, pos = (torch.from_numpy(rng.standard_normal((2, 20, 32)).astype(np.float32))
                for _ in range(2))
    ref = torch.from_numpy(rng.uniform(0, 1, (2, 20, 2, 2)).astype(np.float32))
    mask = torch.zeros(2, 20, dtype=torch.bool)
    with torch.no_grad():
        a = layer(src, pos, ref, shapes, mask)
        b = layer(src, pos, ref, shapes, mask, value=src)
        c = layer(src[:, 16:], pos[:, 16:], ref[:, 16:], shapes, mask, value=src)
    assert torch.equal(a, b) and c.shape == (2, 4, 32)


# ---------------------------------------------------------------- remat


@pytest.fixture(scope="module")
def port_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("arctic"))
    bank = objects.synthetic_object_bank(2, device="cpu")
    arctic.make_synthetic_root(root, num_seqs=1, frames=2, views=1, obj_bank=bank)
    ds = arctic.ArcticDataset(root, "p1", "train", aug=False, kp3d_cano=bank.kp_bottom.numpy(),
                              img_res=RES)
    batch = arctic.collate([ds[i] for i in range(2)])
    world = (mano.synthetic_mano(0, True, device="cpu"),
             mano.synthetic_mano(1, False, device="cpu"), bank)
    return batch, world


def test_remat_gradients_equal_the_plain_run(port_data, monkeypatch):
    """dropout 0.1, feature mask 0.3: the recompute draws the forward's
    masks (a recompute that drew fresh ones would give other gradients)."""
    batch, world = port_data
    kw = dict(CFG, num_encoder_layers=2, dropout=0.1, feature_mask_ratio=0.3)
    calls = []
    forward = EncoderLayer.forward
    monkeypatch.setattr(EncoderLayer, "forward",
                        lambda self, *a, **k: calls.append(1) or forward(self, *a, **k))
    runs = {}
    for remat in (False, True):
        model = UVHandDETR(**kw, remat=remat, generator=torch.Generator().manual_seed(0),
                           device="cpu").train()
        calls.clear()
        gen = torch.Generator().manual_seed(5)
        total, ld = engine.make_loss_fn(model, *world, img_res=float(RES))(
            engine.to_device(batch, "cpu", engine.TRAIN_KEYS), gen)
        total.backward()
        runs[remat] = (ld, {n: p.grad for n, p in model.named_parameters()},
                       gen.get_state(), len(calls))
    (ld0, g0, s0, n0), (ld1, g1, s1, n1) = runs[False], runs[True]
    assert n0 == 2 and n1 == 4  # each encoder layer ran again in the backward
    assert {k: float(v.detach()) for k, v in ld0.items()} == {
        k: float(v.detach()) for k, v in ld1.items()}
    assert torch.equal(s0, s1)
    for n, g in g0.items():
        assert torch.equal(g, g1[n]), n


def test_remat_train_step_equals_the_plain_step(port_data):
    batch, world = port_data
    kw = dict(CFG, dropout=0.1, feature_mask_ratio=0.3)
    params = {}
    for remat in (False, True):
        model = UVHandDETR(**kw, remat=remat, generator=torch.Generator().manual_seed(0),
                           device="cpu")
        step = engine.make_fused_train_step(model, *world, create_optimizer(model),
                                            img_res=float(RES), device="cpu",
                                            generator=torch.Generator().manual_seed(2))
        ld = step(batch)
        params[remat] = (float(ld["total"]), [p.detach().clone() for p in model.parameters()])
    assert params[False][0] == params[True][0]
    assert all(torch.equal(a, b) for a, b in zip(params[False][1], params[True][1]))


# ---------------------------------------------------------------- optimizers


#: an optimizer's test model: a parameter of each group (by name, as
#: `label_params` reads it in both packages), ~0.4M elements
TOY = {"backbone.body.conv.weight": (256, 64, 3, 3), "backbone.body.bn.running_var": (256,),
       "transformer.layer.sampling_offsets.weight": (64, 256),
       "transformer.layer.linear.weight": (512, 256), "transformer.layer.linear.bias": (512,),
       "query_embed.weight": (300, 64)}


def toy_model(dtype=torch.float32):
    rng = np.random.default_rng(0)
    model = torch.nn.Module()
    for name, shape in TOY.items():
        *path, leaf = name.split(".")
        mod = model
        for part in path:
            if not hasattr(mod, part):
                mod.add_module(part, torch.nn.Module())
            mod = getattr(mod, part)
        value = 1.0 + 0.1 * rng.random(shape) if leaf == "running_var" else \
            0.05 * rng.standard_normal(shape)
        mod.register_parameter(leaf, torch.nn.Parameter(
            torch.from_numpy(value.astype(np.float32)).to(dtype)))
    return model


def as_tree(tensors, dtype):
    """{dotted name: tensor} -> the nested dict JAX's optimizer takes. Each
    leaf is a copy: on the CPU `jnp.asarray` may share an aligned numpy
    buffer, and JAX's dispatch is asynchronous, so a leaf sharing a torch
    tensor's memory could be read after torch changed it in place."""
    tree = {}
    for name, t in tensors.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(np.array(t.detach().float().numpy()), dtype)
    return tree


def from_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(from_tree(v, f"{prefix}{k}.") if isinstance(v, dict)
                   else {prefix + k: torch.from_numpy(np.array(v, np.float32))})
    return out


def random_grads(model, step, dtype=jnp.float32):
    """One gradient per parameter from a numpy seed, and the same as a tree."""
    rng = np.random.default_rng(100 + step)
    grads = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)).to(p.dtype)
             for n, p in model.named_parameters()}
    return grads, as_tree(grads, dtype)


def test_sgd_three_steps_equal_optax():
    """At lr 1e-2 (backbone 1e-3) and weight decay 0.1 the decay term moves
    every parameter by many float32 steps over the 3 steps (the clipped
    gradients are ~2e-4 an element, the decayed weights ~5e-3): each move
    p - p0 equals optax's within 1e-4 of the tensor's largest move, plus 4
    float32 steps of p (each package rounds p + u to float32 once a step).
    An SGD without the decay, or with AdamW's decoupled decay, fails it."""
    model = toy_model()
    named = dict(model.named_parameters())
    params = as_tree(named, jnp.float32)
    rates = dict(lr=1e-2, lr_backbone=1e-3, weight_decay=0.1)
    tx = jax_create_optimizer(params, **rates, clip_max_norm=0.1, sgd=True)
    state = tx.init(params)
    opt = create_optimizer(model, **rates, sgd=True)
    assert isinstance(opt, torch.optim.SGD)
    assert [len(g["params"]) for g in opt.param_groups] == [3, 2, 1]
    p0 = {n: p.detach().clone() for n, p in named.items()}
    for i in range(3):
        grads, jgrads = random_grads(model, i)
        updates, state = tx.update(jgrads, state, params)
        params = optax.apply_updates(params, updates)
        for n, p in named.items():
            p.grad = grads[n]
        gl = [p.grad for p in named.values()]
        clip_by_global_norm_(gl, 0.1, global_norm(gl))
        opt.step()
    ref = from_tree(params)
    for n, p in named.items():
        r, o = ref[n].numpy(), p.detach().numpy()
        move, ours = r - p0[n].numpy(), o - p0[n].numpy()
        np.testing.assert_array_less(np.abs(ours - move),
                                     4 * np.spacing(np.abs(r)) + 1e-4 * np.abs(move).max(),
                                     err_msg=n)


def test_stochastic_rounding_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4000) * 10.0 ** rng.integers(-8, 8, 4000),
        -np.abs(rng.standard_normal(500)),
        np.asarray(jnp.asarray(rng.standard_normal(500), jnp.bfloat16), np.float32),  # exact
        np.zeros(8), np.full(8, 1e-40),  # zeros, subnormals
    ]).astype(np.float32).reshape(66, 76)
    key = jax.random.PRNGKey(11)
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint16))
    ref = np.asarray(jax_sr(jnp.asarray(x), key)).view(np.uint16)
    ours = stochastic_round_bf16(torch.from_numpy(x), torch.from_numpy(bits.astype(np.int32)))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(ours.view(torch.int16).numpy().view(np.uint16), ref)


def test_stochastic_rounding_is_unbiased():
    lo = float(torch.tensor(1.0, dtype=torch.bfloat16))
    hi = 1.0 + 2.0 ** -7  # the next bfloat16 above 1
    x = lo + (hi - lo) * 0.25
    gen = torch.Generator().manual_seed(1)
    y = stochastic_round_bf16(torch.full((1024,), lo), generator=gen)
    assert (y.float() == lo).all()  # exact on representables
    y = stochastic_round_bf16(torch.full((8192,), x), generator=gen).float()
    assert set(y.unique().tolist()) <= {lo, hi}
    assert abs(float((y == hi).float().mean()) - 0.25) < 0.02
    yn = stochastic_round_bf16(torch.full((4096,), -x), generator=gen).float()
    assert set(yn.unique().tolist()) <= {-lo, -hi}
    means = [float(stochastic_round_bf16(torch.full((4096,), v), generator=gen).float().mean())
             for v in (0.3, -7.7, 1234.5)]
    np.testing.assert_allclose(means, [0.3, -7.7, 1234.5], rtol=2e-4)
    a = stochastic_round_bf16(torch.full((64,), x), generator=torch.Generator().manual_seed(3))
    b = stochastic_round_bf16(torch.full((64,), x), generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


@pytest.mark.parametrize("sgd", [False, True], ids=["adamw", "sgd"])
def test_bf16_parameter_steps_equal_sr_train_state(sgd):
    """Two steps on the same bf16 gradients with JAX's per-leaf draws
    (`fold_in(PRNGKey(seed), step)` split once per leaf), each from JAX's
    parameters of the step before: the parameters equal `SRTrainState`'s
    bit for bit (99.9% of the elements at least) but
    where the float32 sum x = f32(p) + u differs in its last bits (the two
    packages order the update's float32 operations differently): with the
    same draw the two results are then neighbouring bfloat16 values, one
    step of the larger apart, plus 1e-3 of the tensor's largest move where
    p and u cancel and x keeps few of their bits."""
    model = toy_model(torch.bfloat16)
    named = dict(model.named_parameters())
    state = create_train_state(types.SimpleNamespace(apply=None),
                               {"params": as_tree(named, jnp.bfloat16)},
                               lr=2e-4, lr_backbone=2e-5, weight_decay=1e-4, clip_max_norm=0.1,
                               sgd=sgd, bf16_params=True, sr_seed=42)
    opt = create_optimizer(model, sgd=sgd, sr_seed=42)
    assert isinstance(opt, StochasticRounding)
    params = opt.bf16_params
    assert sorted(map(id, params)) == sorted(map(id, named.values()))
    step = jax.jit(lambda st, g: st.apply_gradients(grads=g))
    for i in range(2):
        grads, jgrads = random_grads(model, i, jnp.bfloat16)
        leaves, treedef = jax.tree.flatten(state.params)
        keys = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(jnp.uint32(42)), state.step), len(leaves))
        jbits = jax.tree.unflatten(treedef, [jax.random.bits(k, leaf.shape, jnp.uint16)
                                             for leaf, k in zip(leaves, keys)])
        bits = {named[n]: b.to(torch.int32) for n, b in from_tree(jbits).items()}
        with torch.no_grad():  # each step from the same parameters (moments: each its own)
            for n, v in from_tree(state.params).items():
                named[n].copy_(v)
        before = {n: p.detach().float().clone() for n, p in named.items()}
        state = step(state, jgrads)
        for n, p in named.items():
            p.grad = grads[n]
        g32 = [p.grad.float() for p in params]
        clip_by_global_norm_(g32, 0.1, global_norm(g32))
        opt.step(grads=g32, bits=bits)
        ref = from_tree(state.params)
        same = total = 0
        for n, p in named.items():
            assert p.dtype == torch.bfloat16
            r, o = ref[n], p.detach().float()
            diff = (o - r).abs()
            # a bfloat16 step of the larger of the two (at most 2^-7 of it)
            bound = (torch.maximum(o.abs(), r.abs()) * 2.0 ** -7
                     + 1e-3 * float((r - before[n]).abs().max()) + 2.0 ** -133)
            assert bool((diff <= bound).all()), (i, n, float(diff.max()))
            same += int((diff == 0).sum())
            total += diff.numel()
        assert same >= 0.999 * total, (i, same, total)
    for c in (c for g in opt.param_groups for c in g["params"]):  # the float32 copies
        assert opt.state[c] and all(v.dtype == torch.float32 for v in opt.state[c].values()
                                    if isinstance(v, torch.Tensor))
    assert all(leaf.dtype == jnp.float32 for leaf in jax.tree.leaves(state.opt_state)
               if jnp.issubdtype(leaf.dtype, jnp.floating))  # the JAX moments too


# ---------------------------------------------------------------- bf16 parameters

BF16 = dict(CFG, two_stage=False, with_box_refine=False)


@pytest.fixture(scope="module")
def bf16_models():
    img = images(1)
    jmodel = JaxDETR(**BF16, compute_dtype=jnp.bfloat16)
    variables = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                             jax_variables(jmodel, img[:1]))
    port = port_of(variables, two_stage=False, with_box_refine=False,
                   compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in port.parameters())
    return jmodel, variables, port


def test_bf16_parameter_layers_match_jax(bf16_models):
    """An encoder layer on bfloat16 input-projection maps and a decoder layer
    on bfloat16 queries (the first layers' inputs under bf16 parameters),
    each with its bf16 parameters: outputs float32 within 3e-2 / 4e-2 of
    their max, as `test_torch_bf16.py` holds the bf16 compute mode."""
    _, variables, port = bf16_models
    rng = np.random.default_rng(3)
    S = sum(h * w for h, w in LEVELS)
    C = CFG["d_model"]
    src = rng.standard_normal((2, S, C)).astype(np.float32)
    pos = rng.standard_normal((2, S, C)).astype(np.float32)
    tgt = rng.standard_normal((2, 12, C)).astype(np.float32)
    qpos = rng.standard_normal((2, 12, C)).astype(np.float32)
    ref2 = rng.uniform(0, 1, (2, S, len(LEVELS), 2)).astype(np.float32)
    refq = rng.uniform(0, 1, (2, 12, len(LEVELS), 2)).astype(np.float32)
    mask = np.zeros((2, S), bool)
    mask[1, -20:] = True
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    tp = variables["params"]["transformer"]
    enc = JaxEncoderLayer(C, CFG["dim_feedforward"], 0.0, len(LEVELS), CFG["n_heads"], 4,
                          compute_dtype=jnp.bfloat16)
    ref_enc = jax.jit(lambda s, p, r, m: enc.apply({"params": tp["encoder_layer0"]}, s, p, r,
                                                   LEVELS, m, False))(
        bf(src), jnp.asarray(pos), jnp.asarray(ref2), jnp.asarray(mask))
    dec = JaxDecoderLayer(C, CFG["dim_feedforward"], 0.0, len(LEVELS), CFG["n_heads"], 4,
                          compute_dtype=jnp.bfloat16)
    ref_dec = jax.jit(lambda t, q, r, s, m: dec.apply({"params": tp["decoder_layer0"]}, t, q, r,
                                                      s, LEVELS, m, False))(
        bf(tgt), bf(qpos), jnp.asarray(refq), jnp.asarray(src), jnp.asarray(mask))
    with torch.no_grad():
        out_enc = port.transformer.encoder.layers[0](
            tb(src), torch.from_numpy(pos), torch.from_numpy(ref2), LEVELS,
            torch.from_numpy(mask))
        out_dec = port.transformer.decoder.layers[0](
            tb(tgt), tb(qpos), torch.from_numpy(refq), torch.from_numpy(src), LEVELS,
            torch.from_numpy(mask))
    assert ref_enc.dtype == jnp.float32 and out_enc.dtype == torch.float32
    assert ref_dec.dtype == jnp.float32 and out_dec.dtype == torch.float32
    assert _rel(out_enc, ref_enc) <= 3e-2
    assert _rel(out_dec, ref_dec) <= 4e-2


@pytest.fixture(scope="module")
def bf16_run(bf16_models, tmp_path_factory):
    """The single-stage model with bf16 parameters: its forward and one
    fused train step's losses in both packages (JAX: its loss function on
    the same weights and batch)."""
    jmodel, variables, port = bf16_models
    root = str(tmp_path_factory.mktemp("arctic"))
    jbank = jobjects.synthetic_object_bank(2)
    jarctic.make_synthetic_root(root, num_seqs=1, frames=4, views=1, obj_bank=jbank)
    ds = jarctic.ArcticDataset(root, "p1", "train", aug=False, two_stage=False,
                               kp3d_cano=np.asarray(jbank.kp_bottom), img_res=RES)
    batch = dict(jarctic.collate([ds[i] for i in range(4)]), images=images(2, 4))
    jworld = (jmano.synthetic_mano(0, True), jmano.synthetic_mano(1, False), jbank)
    tworld = (mano.synthetic_mano(0, True, device="cpu"),
              mano.synthetic_mano(1, False, device="cpu"),
              objects.synthetic_object_bank(2, device="cpu"))
    loss_fn = jengine.make_loss_fn(jmodel, *jworld, img_res=float(RES), two_stage=False)

    @jax.jit
    def jrun(variables, batch):
        _, ld = loss_fn(variables["params"], batch, jax.random.PRNGKey(0))
        return jmodel.apply(variables, batch["images"]), ld

    jout, j_ld = jrun(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        out = port(torch.from_numpy(batch["images"]))
    opt = create_optimizer(port)
    step = engine.make_fused_train_step(port, *tworld, opt, img_res=float(RES), device="cpu")
    before = [p.detach().clone() for p in port.parameters()]
    t_ld = {k: float(v) for k, v in step(batch).items()}
    return dict(jout=jout, out=out, j_ld={k: float(v) for k, v in j_ld.items()}, t_ld=t_ld,
                port=port, opt=opt, before=before)


def test_bf16_parameter_model_matches_jax(bf16_run):
    """Each output within 5e-2 of its max (the bound of
    `test_torch_bf16.py`'s whole-model check)."""
    for k, ref in bf16_run["jout"]["stacked"].items():
        if ref is None:
            assert bf16_run["out"]["stacked"][k] is None
            continue
        assert bf16_run["out"]["stacked"][k].dtype == torch.float32
        assert _rel(bf16_run["out"]["stacked"][k], ref) <= 5e-2, k


def test_bf16_parameter_train_step(bf16_run):
    """The step's losses within 2e-2 of JAX's (`test_torch_bf16.py`'s); the
    parameters stay bfloat16 and finite, every tensor of 4096 elements or
    more moves (a first AdamW step of ~lr rounds up one bfloat16 step with
    probability lr / step, a few percent); the optimizer's state is
    float32."""
    ours, ref = bf16_run["t_ld"], bf16_run["j_ld"]
    assert set(ours) == set(ref) | {"grad_norm"}
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=2e-2, atol=1e-4, err_msg=k)
    for p, old in zip(bf16_run["port"].parameters(), bf16_run["before"]):
        assert p.dtype == torch.bfloat16 and bool(torch.isfinite(p).all())
        assert p.numel() < 4096 or not torch.equal(p, old)
    opt = bf16_run["opt"]
    for c in (c for g in opt.param_groups for c in g["params"]):  # the float32 copies
        assert opt.state[c] and all(v.dtype == torch.float32 for v in opt.state[c].values()
                                    if isinstance(v, torch.Tensor))
