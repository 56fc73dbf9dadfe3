"""The port's ConvNeXt backbone against the JAX package's, on the CPU.

  - one block (`Block` against `ConvNeXtBlock`: 7x7 depthwise conv, LN eps
    1e-6, tanh GELU, layer scale), 1e-5, with layer scales well above their
    1e-6 init so the branch shows; its stochastic depth in train mode;
  - a shrunken ConvNeXt (depths 2/2/2/2, dims 16/32/64/128, as
    `tests/test_convnext.py` shrinks the JAX one: the test patches
    `CONVNEXT_XL_*` of both packages, neither package is edited) inside the
    DINO variant of `UVHandDETR`: the feature maps and every eval output,
    1e-4, and the weights' round trip through the JAX package's
    `convert_reference_detr(dino=True)` and `convert_convnext_checkpoint`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvhand_tpu.models.backbones import convnext as jcx
from uvhand_tpu.models.detr import UVHandDETR as JaxDETR
from uvhand_tpu.train.convert import convert_reference_detr
from uvhand_tpu_torch.models.backbones import convnext as cx
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.train.convert import state_dict_from_jax

from test_torch_model_options import assert_close
from test_torch_train import one_torch_thread  # noqa: F401

DEPTHS = (2, 2, 2, 2)
DIMS = (16, 32, 64, 128)
RES = 128
CFG = dict(num_queries=12, num_encoder_layers=1, num_decoder_layers=2, d_model=64,
           n_heads=4, dim_feedforward=128, dropout=0.0, feature_mask_ratio=0.0,
           two_stage=True, with_box_refine=True, dino_variant=True, use_dn=True,
           look_forward_twice=True, dn_number=2, backbone="convnext_xlarge_22k")


def test_block_equals_jax():
    rng = np.random.default_rng(0)
    block = cx.Block(32)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.from_numpy(rng.normal(scale=0.2, size=p.shape).astype(np.float32)))
        block.gamma.copy_(torch.from_numpy(rng.uniform(0.2, 0.6, 32).astype(np.float32)))
    sd = {k: v.numpy() for k, v in block.state_dict().items()}
    params = {"dwconv": {"kernel": sd["dwconv.weight"].transpose(2, 3, 1, 0),
                         "bias": sd["dwconv.bias"]},
              "norm": {"scale": sd["norm.weight"], "bias": sd["norm.bias"]},
              "pwconv1": {"kernel": sd["pwconv1.weight"].T, "bias": sd["pwconv1.bias"]},
              "pwconv2": {"kernel": sd["pwconv2.weight"].T, "bias": sd["pwconv2.bias"]},
              "gamma": sd["gamma"]}
    x = rng.normal(size=(2, 32, 9, 11)).astype(np.float32)
    ref = jax.jit(jcx.ConvNeXtBlock(32).apply)({"params": params},
                                               jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        out = block(torch.from_numpy(x))
    assert not torch.allclose(out, torch.from_numpy(x), atol=1e-2)  # the branch shows
    assert_close(out.permute(0, 2, 3, 1), ref, tol=1e-5)


def test_block_stochastic_depth_in_train_mode_only():
    block = cx.Block(8, drop_path=0.5).train()
    with torch.no_grad():
        block.gamma.fill_(1.0)
        x = torch.randn(64, 8, 5, 5, generator=torch.Generator().manual_seed(0))
        y = block.eval()(x) - x  # the branch
        out = block.train()(x, torch.Generator().manual_seed(1))
    kept = (out - x).flatten(1).abs().amax(1) > 0
    assert 0.3 < kept.float().mean() < 0.7
    torch.testing.assert_close((out - x)[kept], y[kept] / 0.5)
    with pytest.raises(ValueError, match="generator"):
        block(x)


@pytest.fixture(scope="module")
def shrunk():
    """The JAX and port models with the shrunken ConvNeXt, the port's
    seeded weights (layer scales raised) in both, and their eval outputs."""
    mp = pytest.MonkeyPatch()
    for mod in (jcx, cx):
        mp.setattr(mod, "CONVNEXT_XL_DEPTHS", DEPTHS)
        mp.setattr(mod, "CONVNEXT_XL_DIMS", DIMS)
    mp.setattr(jcx, "CONVNEXT_XL_CHANNELS", DIMS[1:])
    try:
        port = UVHandDETR(**CFG, generator=torch.Generator().manual_seed(0), device="cpu")
        jmodel = JaxDETR(**CFG)
        rng = np.random.default_rng(1)
        with torch.no_grad():
            for name, p in port.named_parameters():
                if name.endswith(".gamma"):
                    p.copy_(torch.from_numpy(rng.uniform(0.1, 0.4, p.shape).astype(np.float32)))
                if name.endswith(("sampling_offsets.weight", "attention_weights.weight")):
                    p.copy_(torch.from_numpy(rng.normal(scale=0.05, size=p.shape)
                                             .astype(np.float32)))
        sd = port.state_dict()
        variables = convert_reference_detr(sd, num_decoder_layers=2, num_encoder_layers=1,
                                           n_heads=4, dino=True, num_feature_levels=4)
        assert "backbone" not in variables["params"]  # it maps the ResNet's names only
        variables["params"]["backbone"] = jcx.convert_convnext_checkpoint(
            {k[len("backbone.0."):]: v for k, v in sd.items() if k.startswith("backbone.0.")},
            depths=DEPTHS)
        images = rng.uniform(-2, 2, (2, RES, RES, 3)).astype(np.float32)

        @jax.jit
        def jrun(variables, images):
            feats = jmodel.apply(variables, images, return_backbone_features=True)
            return feats, jmodel.apply(variables, images)

        feats, jout = jrun(variables, jnp.asarray(images))
        with torch.no_grad():
            t_feats = port.body(torch.from_numpy(images).permute(0, 3, 1, 2))
            out = port(torch.from_numpy(images))
        yield dict(port=port, sd=sd, variables=variables, feats=feats, jout=jout,
                   t_feats=t_feats, out=out)
    finally:
        mp.undo()


def test_convnext_names_are_the_reference_names(shrunk):
    names = set(shrunk["sd"])
    assert {"backbone.0.downsample_layers.0.0.weight", "backbone.0.downsample_layers.3.1.bias",
            "backbone.0.stages.3.1.gamma", "backbone.0.stages.2.0.dwconv.weight",
            "backbone.0.norm1.weight", "backbone.0.norm3.bias"} <= names
    assert not any(k.startswith("backbone.0.body.") for k in names)
    assert shrunk["sd"]["backbone.0.stages.0.0.dwconv.weight"].shape == (16, 1, 7, 7)


def test_converter_round_trip(shrunk):
    back = state_dict_from_jax(shrunk["variables"])
    assert sorted(back) == sorted(shrunk["sd"])
    for k, v in shrunk["sd"].items():
        assert torch.equal(back[k], v), k


def test_feature_maps_equal_jax(shrunk):
    assert [tuple(f.shape) for f in shrunk["t_feats"]] == [(2, 32, 16, 16), (2, 64, 8, 8),
                                                             (2, 128, 4, 4)]
    for ours, ref in zip(shrunk["t_feats"], shrunk["feats"]):
        assert_close(ours.permute(0, 2, 3, 1), ref)


def test_dino_model_with_convnext_equals_jax(shrunk):
    out, jout = shrunk["out"], shrunk["jout"]
    for k, ref in jout["stacked"].items():
        assert_close(out["stacked"][k], ref, what=k)
    for k, ref in jout["interm_outputs"].items():
        assert_close(out["interm_outputs"][k], ref, what=f"interm {k}")
