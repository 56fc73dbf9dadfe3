"""The port's CDN functions (`models/dn.py`) and the DINO variant's position
embeddings against the JAX package's, on the CPU.

  - `CdnConfig`'s group count and pad width and `cdn_attn_mask`, exactly,
    for `dn_number` 1, 2 and 100 (100: 33 groups, 198 queries);
  - the noising arithmetic (`noise_cdn`) under the JAX package's own four
    draws (`jax.random.split(rng, 4)`, drawn as `uvhand_tpu/models/dn.py::
    prepare_cdn` draws them), bit for bit: the labels, the noised keys
    before the logit (the JAX logit of the port's equals JAX's exactly) and
    every other tensor; the port's logit within 2 ulp of JAX's (XLA's CPU
    `log` and torch's round some values 1 ulp apart);
  - `prepare_cdn` on the port's generator: the flip rate near
    label_noise_ratio / 2, negatives noisier than positives, keys clamped
    to [0, 1] before the logit;
  - `dn_losses` on random inputs with invalid slots, 1e-5;
  - `sine_embed_42` and the sine position encoding without its half-cell
    shift (temperature 20), 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvhand_tpu.models import dn as jdn
from uvhand_tpu.models.posenc import sine_position_encoding as jax_sine
from uvhand_tpu.models.transformer import inverse_sigmoid as jax_inverse_sigmoid
from uvhand_tpu.models.transformer import sine_embed_42 as jax_sine_embed_42
from uvhand_tpu_torch.models import dn
from uvhand_tpu_torch.models.posenc import sine_position_encoding
from uvhand_tpu_torch.models.transformer import sine_embed_42

NUM_CLASSES = 14
# one compile (eager JAX compiles every op on its own)
jax_dn_losses = jax.jit(jdn.dn_losses)


def targets(rng, B=3):
    labels = rng.integers(1, NUM_CLASSES, (B, 3)).astype(np.int32)
    labels[:, 1:] = [12, 13]
    valid = rng.uniform(size=(B, 3)) > 0.3
    labels[~valid] = -1
    kps = rng.uniform(0.05, 0.95, (B, 3, 42)).astype(np.float32)
    return labels, kps, valid


@pytest.mark.parametrize("dn_number,groups", [(1, 2), (2, 4), (100, 33)])
def test_groups_pad_and_attention_mask_equal_jax(dn_number, groups):
    ours, ref = dn.CdnConfig(dn_number), jdn.CdnConfig(dn_number)
    assert ours.groups == ref.groups == groups
    assert ours.pad_size == ref.pad_size == 6 * groups
    mask = dn.cdn_attn_mask(300, ours)
    assert mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jdn.cdn_attn_mask(300, ref)))


def test_noising_with_the_jax_draws_is_bit_exact(dn_number=100, ratio=0.8, scale=0.4):
    """Against the JAX function run op by op (under `jax.jit` XLA contracts
    the noise's multiply-add, which moves last bits)."""
    labels, kps, valid = targets(np.random.default_rng(dn_number))
    cfg = dn.CdnConfig(dn_number, ratio, scale)
    B, G = labels.shape[0], cfg.groups
    rng = jax.random.PRNGKey(dn_number)
    ref = jdn.prepare_cdn(rng, jnp.asarray(labels), jnp.asarray(kps), jnp.asarray(valid),
                          NUM_CLASSES, jdn.CdnConfig(dn_number, ratio, scale))
    # the JAX package's draws, as its prepare_cdn takes them
    # (the same calls as there, so their compiles are shared)
    r1, r2, r3, r4 = jax.random.split(rng, 4)
    lab, key = (B, G, 2, 3), (B, G, 2, 3, 42)
    draws = {"flip": jax.random.uniform(r1, lab),
             "labels": jax.random.randint(r2, lab, 0, NUM_CLASSES),
             "sign": jax.random.randint(r3, key, 0, 2),
             "part": jax.random.uniform(r4, key)}
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    ours = dn.noise_cdn(torch.from_numpy(labels), torch.from_numpy(kps),
                        torch.from_numpy(valid), cfg, draws)
    assert sorted(ours) == sorted(ref)
    assert bool((draws["flip"] < ratio / 2).any())  # some labels flip
    for k, v in ref.items():
        if k != "dn_keys_unact":
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    keys = dn.noised_keys(torch.from_numpy(kps), cfg, draws)
    np.testing.assert_array_equal(np.asarray(jax_inverse_sigmoid(jnp.asarray(keys.numpy()))),
                                  np.asarray(ref["dn_keys_unact"]))
    np.testing.assert_allclose(ours["dn_keys_unact"].numpy(), np.asarray(ref["dn_keys_unact"]),
                               rtol=2.4e-7, atol=0)


def test_prepare_cdn_distribution_on_the_port_generator():
    labels, kps, valid = targets(np.random.default_rng(0), B=64)
    cfg = dn.CdnConfig(100, 0.5, 1.0)
    gen = torch.Generator().manual_seed(0)
    meta = dn.prepare_cdn(gen, torch.from_numpy(labels), torch.from_numpy(kps),
                          torch.from_numpy(valid), NUM_CLASSES, cfg)
    P = cfg.pad_size
    assert meta["dn_keys_unact"].shape == (64, P, 42)
    # a flipped label is a uniform class, so it differs with p 13/14
    changed = (meta["dn_labels_noised"] != meta["dn_labels_gt"]).float().mean().item()
    assert abs(changed - 0.25 * 13 / 14) < 0.01, changed
    neg = meta["dn_is_negative"]
    assert int(neg.sum()) == 64 * P // 2
    keys = torch.sigmoid(meta["dn_keys_unact"])
    err = (keys - meta["dn_keys_gt"]).abs()
    assert err[neg].mean() > 1.5 * err[~neg].mean()
    # clamped to [0, 1] before the logit (inverse_sigmoid's eps 1e-5 bounds it)
    assert meta["dn_keys_unact"].abs().max() <= np.log((1 - 1e-5) / 1e-5) + 1e-4
    # a draw moves with the generator
    again = dn.prepare_cdn(gen, torch.from_numpy(labels), torch.from_numpy(kps),
                           torch.from_numpy(valid), NUM_CLASSES, cfg)
    assert not torch.equal(again["dn_keys_unact"], meta["dn_keys_unact"])


def test_dn_losses_equal_jax():
    """On the noising test's shapes (its op-by-op compiles are reused)."""
    rng = np.random.default_rng(5)
    labels, kps, valid = targets(rng)
    cfg = dn.CdnConfig(100)
    meta = jdn.prepare_cdn(jax.random.PRNGKey(1), jnp.asarray(labels), jnp.asarray(kps),
                           jnp.asarray(valid), NUM_CLASSES, jdn.CdnConfig(100))
    L, B, P = 3, labels.shape[0], cfg.pad_size
    logits = rng.normal(scale=3.0, size=(L, B, P, NUM_CLASSES)).astype(np.float32)
    hand = rng.uniform(-1, 1, (L, B, P, 42)).astype(np.float32)
    obj = rng.uniform(-1, 1, (L, B, P, 42)).astype(np.float32)
    num_boxes = np.float32(valid.sum())
    ref = jax_dn_losses(jnp.asarray(logits), jnp.asarray(hand), jnp.asarray(obj), meta,
                        jnp.asarray(num_boxes))
    ours = dn.dn_losses(torch.from_numpy(logits), torch.from_numpy(hand), torch.from_numpy(obj),
                        {k: torch.from_numpy(np.array(v)) for k, v in meta.items()},
                        torch.tensor(num_boxes))
    assert sorted(ours) == sorted(ref) and "loss_obj_keypoint_dn_1" in ours
    for k, v in ref.items():
        np.testing.assert_allclose(float(ours[k]), float(v), rtol=1e-5, err_msg=k)


def test_sine_embed_42_equals_jax():
    pos = np.random.default_rng(2).uniform(-1, 1, (2, 7, 42)).astype(np.float32)
    ours = sine_embed_42(torch.from_numpy(pos))
    assert ours.shape == (2, 7, 256)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax.jit(jax_sine_embed_42)(pos)),
                               rtol=0, atol=1e-6)


def test_unshifted_sine_encoding_equals_jax():
    mask = np.zeros((2, 9, 13), bool)
    mask[1, 6:, :] = True
    mask[1, :, 10:] = True
    ours = sine_position_encoding(torch.from_numpy(mask), 32, temperature=20.0,
                                  center_shift=False)
    ref = jax.jit(jax_sine, static_argnums=(1, 2), static_argnames="center_shift")(
        jnp.asarray(mask), 32, 20.0, center_shift=False)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    shifted = sine_position_encoding(torch.from_numpy(mask), 32, temperature=20.0)
    assert not torch.allclose(shifted, ours)
