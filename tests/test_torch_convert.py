"""The port's weight bridge (`uvhand_tpu_torch/train/convert.py`) and the
JAX package's `convert_reference_detr` are exact inverses."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from uvhand_tpu.models.detr import UVHandDETR as JaxDETR
from uvhand_tpu.train.convert import convert_reference_detr
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.train.convert import state_dict_from_jax

ENC, DEC, QUERIES = 1, 2, 12


def _port():
    return UVHandDETR(num_queries=QUERIES, num_encoder_layers=ENC, num_decoder_layers=DEC,
                      d_model=64, n_heads=4, dim_feedforward=128,
                      generator=torch.Generator().manual_seed(3), device="cpu")


def test_port_to_jax_to_port_is_exact():
    port = _port()
    sd = port.state_dict()
    tree = convert_reference_detr(sd, num_decoder_layers=DEC, num_encoder_layers=ENC, n_heads=4)
    back = state_dict_from_jax(tree)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    port.load_state_dict(back)  # strict: names and shapes are the port's


def test_jax_to_port_to_jax_is_exact():
    model = JaxDETR(num_queries=QUERIES, num_encoder_layers=ENC, num_decoder_layers=DEC,
                    d_model=64, n_heads=4, dim_feedforward=128, dropout=0.0,
                    feature_mask_ratio=0.0)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 64, 64, 3), jnp.float32)))
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = state_dict_from_jax(params)
    _port().load_state_dict(sd)
    back = convert_reference_detr(sd, num_decoder_layers=DEC, num_encoder_layers=ENC, n_heads=4)
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(map(jax.tree_util.keystr, flat)) == set(map(jax.tree_util.keystr, flat_back))
    by_name = {jax.tree_util.keystr(k): v for k, v in flat_back.items()}
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(by_name[jax.tree_util.keystr(k)]), v,
                                      err_msg=jax.tree_util.keystr(k))
