"""The port's model (`uvhand_tpu_torch.models`) against the JAX model.

Weights are drawn once in the port, carried to the JAX tree with the JAX
package's `convert_reference_detr`, and both forwards run on the same numpy
image on the CPU. The MSDA offset/attention projections are overwritten with
seeded random values so that every query samples its own locations (the
reference init zeroes them). Tolerance: atol = rtol = 1e-4 in float32 -- the
two frameworks sum convolutions and matrix products in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvhand_tpu.models import posenc as jax_posenc
from uvhand_tpu.models.detr import UVHandDETR as JaxDETR
from uvhand_tpu.models.transformer import _class_masks as jax_class_masks
from uvhand_tpu.train.convert import convert_reference_detr
from uvhand_tpu_torch.models import posenc
from uvhand_tpu_torch.models.detr import UVHandDETR, resize_mask
from uvhand_tpu_torch.models.transformer import _class_masks

ENC, DEC, QUERIES, RES = 2, 2, 50, 128
TOL = dict(atol=1e-4, rtol=1e-4)


def _close(name, ours, ref):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, err_msg=name, **TOL)


@pytest.fixture(scope="module")
def models():
    gen = torch.Generator().manual_seed(0)
    port = UVHandDETR(num_queries=QUERIES, num_encoder_layers=ENC,
                      num_decoder_layers=DEC, generator=gen, device="cpu")
    rng = np.random.default_rng(1)
    sd = port.state_dict()
    for k, v in sd.items():
        if k.endswith(("sampling_offsets.weight", "attention_weights.weight")):
            v.copy_(torch.from_numpy(rng.normal(scale=0.02, size=v.shape).astype(np.float32)))
    variables = convert_reference_detr(sd, num_decoder_layers=DEC,
                                       num_encoder_layers=ENC, n_heads=8)
    jax_model = JaxDETR(num_queries=QUERIES, num_encoder_layers=ENC,
                        num_decoder_layers=DEC, dropout=0.0, feature_mask_ratio=0.0)
    return port, jax_model, variables


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
def test_forward_matches_jax(models, padded):
    """Every head, aux and interm output; with a padded image mask too
    (valid ratios, masked values and proposals)."""
    port, jax_model, variables = models
    img = np.random.default_rng(2).normal(size=(2, RES, RES, 3)).astype(np.float32)
    mask = np.zeros((2, RES, RES), bool)
    if padded:
        mask[0, :, 96:] = True
        mask[1, 112:, :] = True
    ref = jax.jit(lambda v, x, m: jax_model.apply(v, x, m, train=False))(
        variables, jnp.asarray(img), jnp.asarray(mask))
    with torch.no_grad():
        out = port(torch.from_numpy(img), torch.from_numpy(mask))

    # the two-stage top-k must pick the same proposals, with no near ties
    enc_scores = np.asarray(ref["interm_outputs"]["pred_logits"]).max(-1)
    top = np.sort(enc_scores, 1)[:, ::-1][:, : QUERIES + 1]
    assert np.min(top[:, :-1] - top[:, 1:]) > 1e-5, "tied top-k scores in the test input"

    for k, v in ref["stacked"].items():
        _close(f"stacked/{k}", out["stacked"][k], v)
    for k in ("pred_logits", "pred_hand_key", "pred_obj_key"):
        _close(k, out[k], ref[k])
        _close(f"interm/{k}", out["interm_outputs"][k], ref["interm_outputs"][k])
    assert len(out["aux_outputs"]) == len(ref["aux_outputs"]) == DEC - 1
    for ours, theirs in zip(out["aux_outputs"], ref["aux_outputs"]):
        for k in ("pred_logits", "pred_hand_key", "pred_obj_key"):
            _close(f"aux/{k}", ours[k], theirs[k])
        for k in ("pred_mano_params", "pred_obj_params", "pred_cams"):
            for a, b in zip(ours[k], theirs[k]):
                _close(f"aux/{k}", a, b)


def test_level_features_with_padding_mask(models):
    """Per-level features, resized masks and sine encodings, with a padded
    image mask (half-pixel-centre nearest resize)."""
    port, jax_model, variables = models
    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, RES, RES, 3)).astype(np.float32)
    mask = np.zeros((2, RES, RES), bool)
    mask[0, :, 100:] = True
    mask[1, 77:, :] = True

    def jax_levels(x, m):
        feats = jax_model.apply(variables, x, return_backbone_features=True)
        srcs, masks, poses = [], [], []
        for lvl in range(4):
            proj = jax_model.bind(variables).input_projs[lvl]
            src = proj(feats[lvl] if lvl < 3 else feats[-1])
            mm = jax.image.resize(m.astype(jnp.float32), (2,) + src.shape[1:3],
                                  "nearest").astype(bool)
            srcs.append(src)
            masks.append(mm)
            poses.append(jax_posenc.sine_position_encoding(mm, 128))
        return srcs, masks, poses

    srcs_j, masks_j, poses_j = jax.jit(jax_levels)(jnp.asarray(img), jnp.asarray(mask))
    with torch.no_grad():
        srcs, masks, poses = port.level_features(torch.from_numpy(img), torch.from_numpy(mask))
    for lvl in range(4):
        _close(f"src{lvl}", srcs[lvl].permute(0, 2, 3, 1), srcs_j[lvl])
        np.testing.assert_array_equal(masks[lvl].numpy(), np.asarray(masks_j[lvl]))
        assert masks[lvl].any(), "the padded mask must reach every level"
        _close(f"pos{lvl}", poses[lvl], poses_j[lvl])


@pytest.mark.parametrize("shape", [(37, 53), (5, 3), (1, 1)])
def test_resize_mask_matches_jax_nearest(shape):
    mask = np.random.default_rng(4).random((2, 29, 41)) > 0.5
    ours = resize_mask(torch.from_numpy(mask), shape).numpy()
    ref = jax.image.resize(jnp.asarray(mask, jnp.float32), (2,) + shape, "nearest")
    np.testing.assert_array_equal(ours, np.asarray(ref).astype(bool))


def test_sine_position_encoding_matches_jax():
    mask = np.random.default_rng(5).random((2, 9, 13)) > 0.7
    ours = posenc.sine_position_encoding(torch.from_numpy(mask), 64)
    ref = jax_posenc.sine_position_encoding(jnp.asarray(mask), 64)
    _close("posenc", ours, ref)


def test_class_masks_match_jax():
    idx = np.random.default_rng(6).integers(0, 14, size=(3, 40))
    for ours, ref in zip(_class_masks(torch.from_numpy(idx)), jax_class_masks(jnp.asarray(idx))):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
