"""The port's bf16 compute mode against the JAX package's (`compute_dtype`).

The tiny model of `tests/test_torch_train.py` (1 encoder and 2 decoder
layers, d=64, 4 heads, 12 queries, 128x128, dropout 0, feature mask 0) on
that test's batch is
built by the port with `compute_dtype=torch.bfloat16`, its seeded weights
carried to the JAX tree by `convert_reference_detr`; the JAX model runs with
`compute_dtype=jnp.bfloat16`. Both keep float32 parameters.

bf16 rounds every product in both packages, in sums taken in other orders,
so outputs differ by a few bf16 steps (2^-8 relative) where float32 agrees
to 1e-6. A discrete choice of the forward would turn that into a different
output, so the weights are set to make every such choice exact in both
packages: the encoder's class head reads nothing (its scores tie exactly,
and both packages' top-k then take the lowest token indices first; the
top-k itself is held in float32 by `test_torch_model.py`), and the layer-0
class head prefers a hand class by a margin far above the bf16 error, so
the decoder's refinement gate is the same. The refinement, the proposals and
every bf16 layer still run; the asserts below check both choices.

Tolerances, each a little above the error measured here:
  - one encoder / decoder layer: 3e-2 / 4e-2 of the output's max|value|;
  - the whole model, relative to each output's max|value| (the bound is
    5e-2): stacked heads 2e-2 (measured 1.2e-2, the hand camera), the
    aux layer's heads 3e-2 (2.6e-2, the object radian), interm keypoints
    3e-2 (2.2e-2);
  - one train step, both packages' criteria on the port's GT targets
    (float32 in either mode, held against JAX by `test_torch_train.py`):
    matcher assignments identical at every decoder layer and the interm
    outputs; loss terms 2e-2 relative, grad_norm 5e-2
    (3.4e-2: the random ResNet-50's bf16 backward dominates it); each
    gradient within a relative L2 error (||ours - JAX|| / ||JAX||) of 0.15
    in the transformer and heads (measured 0.10: the interm keypoint heads,
    whose L1 losses flip the sign of their gradient wherever a bf16
    prediction lies within its rounding of the target) and 0.3 in the
    backbone and input projections (0.22: bf16 convolutions and their bf16
    backward through 50 random layers). An L2 norm, not a max, since a sign
    flip of an L1 gradient moves single elements by their whole size.
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
from uvhand_tpu.losses.matching import arctic_match as jax_match
from uvhand_tpu.models.detr import UVHandDETR as JaxDETR
from uvhand_tpu.models.transformer import DecoderLayer as JaxDecoderLayer
from uvhand_tpu.models.transformer import Drop as JaxDrop
from uvhand_tpu.models.transformer import EncoderLayer as JaxEncoderLayer
from uvhand_tpu.train.convert import convert_reference_detr
from uvhand_tpu_torch import engine
from uvhand_tpu_torch.data.process import process_targets
from uvhand_tpu_torch.geometry import mano, objects
from uvhand_tpu_torch.losses.matching import arctic_match
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.models.transformer import Drop
from uvhand_tpu_torch.train.convert import state_dict_from_jax

from test_torch_train import CFG, RES, one_torch_thread  # noqa: F401 (autouse)

LEVELS = ((16, 16), (8, 8), (4, 4), (2, 2))  # a 128x128 image
HAND = 12  # left-hand class


def _rel(ours, ref):
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def models():
    port = UVHandDETR(**CFG, dropout=0.0, feature_mask_ratio=0.0,
                      compute_dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith(("sampling_offsets.weight", "attention_weights.weight")):
                p.copy_(torch.from_numpy(rng.normal(scale=0.05, size=p.shape).astype(np.float32)))
        enc_head = port.cls_embed[port.num_decoder_layers]
        enc_head.weight.zero_()  # every token scores its bias: exact ties
        enc_head.bias[0] += 1.0  # class 0: the proposals are the references
        # layer 0: both hand classes lead the others by a wide margin, so the
        # refinement gate takes every query as a hand, and the queries split
        # between left and right by a wide margin, so the matcher's hand
        # assignments are the same in both packages
        head = port.cls_embed[0]
        w = head.weight[HAND].clone()
        head.weight[HAND], head.weight[HAND + 1] = 4.0 * w, -4.0 * w
        head.bias[HAND] = head.bias[HAND + 1] = 8.0
    variables = convert_reference_detr(port.state_dict(), num_decoder_layers=2,
                                       num_encoder_layers=1, n_heads=4)
    jax_model = JaxDETR(**CFG, dropout=0.0, feature_mask_ratio=0.0, compute_dtype=jnp.bfloat16)
    return port, jax_model, variables


def _layer_inputs(seed, lq, ref_dim):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in LEVELS)
    C = CFG["d_model"]
    src = rng.standard_normal((2, S, C)).astype(np.float32)
    pos = rng.standard_normal((2, S, C)).astype(np.float32)
    tgt = rng.standard_normal((2, lq, C)).astype(np.float32)
    query_pos = rng.standard_normal((2, lq, C)).astype(np.float32)
    ref = rng.uniform(0.0, 1.0, size=(2, lq, len(LEVELS), ref_dim)).astype(np.float32)
    mask = np.zeros((2, S), bool)
    mask[1, -20:] = True
    return src, pos, tgt, query_pos, ref, mask


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_drop_scales_as_jax(rate, dtype):
    """Train-mode dropout scales a kept element by 1 / keep with keep in the
    activation's type, as JAX's `Drop` does: the masks come from different
    generators, but every element both keep is equal bit for bit."""
    x = np.random.default_rng(5).standard_normal((64, 256)).astype(np.float32)
    ref = np.asarray(JaxDrop(rate, False).apply(
        {}, jnp.asarray(x, dtype), rngs={"dropout": jax.random.PRNGKey(0)}), np.float32)
    drop = Drop(rate).train()
    out = drop(torch.from_numpy(x).to(getattr(torch, dtype)),
               torch.Generator().manual_seed(0)).float().numpy()
    both = (ref != 0) & (out != 0)
    assert both.sum() > 0.4 * x.size
    np.testing.assert_array_equal(out[both], ref[both])


def test_encoder_layer_matches_jax(models):
    port, _, variables = models
    src, pos, _, _, ref, mask = _layer_inputs(3, sum(h * w for h, w in LEVELS), 2)
    layer = JaxEncoderLayer(CFG["d_model"], CFG["dim_feedforward"], 0.0, len(LEVELS),
                            CFG["n_heads"], 4, compute_dtype=jnp.bfloat16)
    params = {"params": variables["params"]["transformer"]["encoder_layer0"]}
    ref_out = jax.jit(lambda s, p, r, m: layer.apply(params, s, p, r, LEVELS, m, False))(
        *(jnp.asarray(x) for x in (src, pos, ref, mask)))
    with torch.no_grad():
        out = port.transformer.encoder.layers[0](
            torch.from_numpy(src), torch.from_numpy(pos), torch.from_numpy(ref), LEVELS,
            torch.from_numpy(mask))
    assert out.dtype == torch.float32
    assert _rel(out, ref_out) <= 3e-2


def test_decoder_layer_matches_jax(models):
    port, _, variables = models
    src, _, tgt, query_pos, ref, mask = _layer_inputs(4, 12, 42)
    layer = JaxDecoderLayer(CFG["d_model"], CFG["dim_feedforward"], 0.0, len(LEVELS),
                            CFG["n_heads"], 4, compute_dtype=jnp.bfloat16)
    params = {"params": variables["params"]["transformer"]["decoder_layer0"]}
    ref_out = jax.jit(lambda t, qp, r, s, m: layer.apply(params, t, qp, r, s, LEVELS, m, False))(
        *(jnp.asarray(x) for x in (tgt, query_pos, ref, src, mask)))
    with torch.no_grad():
        out = port.transformer.decoder.layers[0](
            torch.from_numpy(tgt), torch.from_numpy(query_pos), torch.from_numpy(ref),
            torch.from_numpy(src), LEVELS, torch.from_numpy(mask))
    assert out.dtype == torch.float32
    assert _rel(out, ref_out) <= 4e-2


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """`test_torch_train.py`'s batch (4 frames of a synthetic ARCTIC root at
    128x128), both packages' synthetic MANO and object bank, and the port's
    GT targets (float32 in either mode; held against JAX there)."""
    root = str(tmp_path_factory.mktemp("arctic"))
    jbank = jobjects.synthetic_object_bank(2)
    arctic.make_synthetic_root(root, num_seqs=1, frames=4, views=1, obj_bank=jbank)
    ds = arctic.ArcticDataset(root, "p1", "train", aug=False,
                              kp3d_cano=np.asarray(jbank.kp_bottom), img_res=RES)
    batch = arctic.collate([ds[i] for i in range(4)])
    jworld = (jmano.synthetic_mano(0, True), jmano.synthetic_mano(1, False), jbank)
    tworld = (mano.synthetic_mano(0, True, device="cpu"),
              mano.synthetic_mano(1, False, device="cpu"),
              objects.synthetic_object_bank(2, device="cpu"))
    with torch.no_grad():
        targets = process_targets(engine.to_device(batch, "cpu", engine.TRAIN_KEYS), *tworld,
                                  float(RES))
    return batch, jworld, tworld, targets


@pytest.fixture(scope="module")
def forward(models, data):
    """Both packages' outputs on the batch's images. With dropout and the
    feature mask at 0 they are the train-mode outputs too."""
    port, jax_model, variables = models
    images = data[0]["images"]
    ref = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, jnp.asarray(images))
    with torch.no_grad():
        out = port(torch.from_numpy(images))
    return ref, out


def test_model_matches_jax(forward):
    """Every head, aux and interm output of the whole bf16 model."""
    ref, out = forward
    # the two discrete choices are exact: tied encoder scores, the hand gate
    enc_logits = np.asarray(ref["interm_outputs"]["pred_logits"])
    assert (enc_logits.max(-1) == enc_logits.max()).all()
    layer0 = np.asarray(ref["stacked"]["pred_logits"][0])
    hand, other = layer0[..., HAND:HAND + 2].max(-1), np.delete(layer0, [HAND, HAND + 1], -1)
    assert (hand - other.max(-1)).min() > 2.0

    for k, v in ref["stacked"].items():
        assert out["stacked"][k].dtype == torch.float32, k
        assert _rel(out["stacked"][k], v) <= 2e-2, k
    for k in ("pred_logits", "pred_hand_key", "pred_obj_key"):
        assert _rel(out["interm_outputs"][k], ref["interm_outputs"][k]) <= 3e-2, k
    for ours, theirs in zip(out["aux_outputs"], ref["aux_outputs"]):
        for k in ("pred_mano_params", "pred_obj_params", "pred_cams"):
            for a, b in zip(ours[k], theirs[k]):
                assert _rel(a, b) <= 3e-2, k


@pytest.fixture(scope="module")
def train_run(models, data, forward):
    """One loss and backward of the bf16 model in train mode, in both
    packages, from the same targets, with both packages' matcher
    assignments on their outputs."""
    port, jax_model, variables = models
    batch, jworld, tworld, targets = data
    loss_fn = jengine.make_loss_fn(jax_model, *jworld, img_res=float(RES), preprocess=False)
    jb = {"images": jnp.asarray(batch["images"]),
          "targets": {k: jnp.asarray(v.numpy()) for k, v in targets.items()}}

    @jax.jit
    def jstep(params):
        (_, ld), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, jb, jax.random.PRNGKey(0))
        ld["grad_norm"] = jengine.global_norm(grads)
        return ld, grads

    j_ld, j_grads = jstep(variables["params"])

    port.train()
    port.zero_grad(set_to_none=True)
    try:
        total, t_ld = engine.make_loss_fn(port, *tworld, img_res=float(RES), preprocess=False)(
            {"images": torch.from_numpy(batch["images"]), "targets": targets}, None)
        total.backward()
    finally:
        port.eval()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
             for n, p in port.named_parameters()}
    port.zero_grad(set_to_none=True)
    t_ld = {k: float(v.detach()) for k, v in t_ld.items()}
    t_ld["grad_norm"] = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                          for g in grads.values())))

    tgt = {k: batch[k] for k in ("labels", "keypoints", "target_valid")}
    valid = tgt["target_valid"] & (batch["is_valid"][:, None] > 0)

    def assignments(out, match, conv):
        heads = [(out["stacked"]["pred_logits"][i], out["stacked"]["pred_hand_key"][i],
                  out["stacked"]["pred_obj_key"][i]) for i in range(CFG["num_decoder_layers"])]
        io = out["interm_outputs"]
        heads.append((io["pred_logits"], io["pred_hand_key"], io["pred_obj_key"]))
        return [np.asarray(match(*h, conv(tgt["labels"]), conv(tgt["keypoints"]),
                                 conv(valid))) for h in heads]

    j_out, t_out = forward
    return dict(
        j_ld={k: float(v) for k, v in j_ld.items()}, t_ld=t_ld,
        j_grads={k: v.numpy() for k, v in state_dict_from_jax(j_grads).items()},
        t_grads=grads,
        j_assign=assignments(j_out, jax_match, jnp.asarray),
        t_assign=assignments(t_out, arctic_match, torch.from_numpy))


def test_train_step_matches_jax(train_run):
    r = train_run
    for a, b in zip(r["t_assign"], r["j_assign"]):
        np.testing.assert_array_equal(a, b)
    assert set(r["t_ld"]) == set(r["j_ld"])
    for k, ref in r["j_ld"].items():
        rtol = 5e-2 if k == "grad_norm" else 2e-2
        np.testing.assert_allclose(r["t_ld"][k], ref, rtol=rtol, atol=1e-4, err_msg=k)
    assert set(r["t_grads"]) <= set(r["j_grads"])
    for name, g in r["t_grads"].items():
        ref = r["j_grads"][name]
        err = np.linalg.norm(g - ref) / max(np.linalg.norm(ref), 1e-30)
        tol = 0.3 if name.startswith(("backbone.", "input_proj.")) else 0.15
        assert err <= tol, (name, err)
