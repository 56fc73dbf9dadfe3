"""The port's optimizer, clip and schedules against optax, and its train-mode
randomness by distribution.

Optimizer: parameter groups by the JAX package's `label_params`, three AdamW
steps with the global-norm clip against `create_optimizer` of the JAX
package on the same gradients (1e-6 relative: the same formulas, rounded in
another order), and the OneCycle / step schedules against optax's values.

Randomness: the port draws from `torch.Generator`s, JAX from its own keys,
so dropout, the feature mask and the attention-weight dropout are checked by
what they must be -- keep share, scaling, broadcast -- and by being
repeatable from a seed.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

from uvhand_tpu.train import state as jstate
from uvhand_tpu.train.convert import convert_reference_detr
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.models.transformer import Drop, self_attention
from uvhand_tpu_torch.train import state

CFG = dict(num_queries=12, num_encoder_layers=1, num_decoder_layers=2, d_model=64,
           n_heads=4, dim_feedforward=128)


@pytest.fixture(scope="module")
def tiny():
    return UVHandDETR(**CFG, generator=torch.Generator().manual_seed(0), device="cpu")


def test_param_groups_match_jax_labels(tiny):
    tree = convert_reference_detr(tiny.state_dict(), num_decoder_layers=2,
                                  num_encoder_layers=1, n_heads=4)["params"]
    sizes = {}
    for label, leaf in zip(jax.tree.leaves(jstate.label_params(tree)), jax.tree.leaves(tree)):
        sizes[label] = sizes.get(label, 0) + int(np.size(leaf))
    ours = {}
    params = dict(tiny.named_parameters())
    for name, label in state.label_params(tiny).items():
        ours[label] = ours.get(label, 0) + params[name].numel()
    assert ours == sizes
    # the frozen-BN tensors train with the backbone, as every JAX leaf does
    assert state.label_params(tiny)["backbone.0.body.bn1.running_var"] == "backbone"
    opt = state.create_optimizer(tiny)
    assert [g["name"] for g in opt.param_groups] == list(state.GROUPS)
    assert [g["lr"] for g in opt.param_groups] == [2e-4, 2e-5, 2e-5]
    assert all(g["weight_decay"] == 1e-4 and g["betas"] == (0.9, 0.999) and g["eps"] == 1e-8
               for g in opt.param_groups)
    assert sum(len(g["params"]) for g in opt.param_groups) == len(params)


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = nn.Linear(4, 3)
        self.sampling_offsets = nn.Linear(3, 2)
        self.head = nn.Linear(2, 5)


@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["under_clip", "over_clip"])
def test_adamw_with_clip_matches_optax(scale):
    rng = np.random.default_rng(0)
    toy = Toy()
    with torch.no_grad():
        for p in toy.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    names = [n for n, _ in toy.named_parameters()]
    tree = {n.replace(".", "/"): jnp.asarray(p.detach().numpy()) for n, p in toy.named_parameters()}
    tx = jstate.create_optimizer(tree, clip_max_norm=0.1)
    opt_state = tx.init(tree)
    opt = state.create_optimizer(toy)
    for _ in range(3):
        grads = {n: (scale * rng.standard_normal(p.shape)).astype(np.float32)
                 for n, p in toy.named_parameters()}
        jg = {n.replace(".", "/"): jnp.asarray(g) for n, g in grads.items()}
        updates, opt_state = tx.update(jg, opt_state, tree)
        tree = optax.apply_updates(tree, updates)
        ps = [p for _, p in toy.named_parameters()]
        for p, n in zip(ps, names):
            p.grad = torch.from_numpy(grads[n])
        gs = [p.grad for p in ps]
        norm = state.global_norm(gs)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)), rtol=1e-6)
        state.clip_by_global_norm_(gs, 0.1, norm)
        opt.step()
    for n, p in toy.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(tree[n.replace(".", "/")]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def test_clip_is_optax_formula():
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    for max_norm in (0.1, 100.0):
        ref = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)[0]
        ours = [torch.from_numpy(g.copy()) for g in grads]
        state.clip_by_global_norm_(ours, max_norm, state.global_norm(ours))
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6)
    # at or under the limit the gradients are left as they are, bit for bit
    g = [torch.tensor([0.06, 0.08])]
    state.clip_by_global_norm_(g, 0.2, state.global_norm(g))
    assert g[0].tolist() == torch.tensor([0.06, 0.08]).tolist()


def test_schedules_match_optax():
    steps = np.arange(0, 130)
    ref = jstate.onecycle_schedule(2e-4, 100)
    ours = state.onecycle_schedule(2e-4, 100)
    # optax evaluates in float32, the port in float64: 1e-6 of the peak rate
    np.testing.assert_allclose([ours(int(s)) for s in steps],
                               [float(ref(jnp.int32(s))) for s in steps], rtol=1e-6, atol=2e-10)
    ref = jstate.step_schedule(2e-4, 30)
    ours = state.step_schedule(2e-4, 30)
    np.testing.assert_allclose([ours(int(s)) for s in steps], [ref(int(s)) for s in steps],
                               rtol=1e-12)
    # a LambdaLR over the three groups follows the schedule, step 0 first
    toy = Toy()
    opt = state.create_optimizer(toy)
    sched = state.scheduled(opt, ours, lr=2e-4)
    for s in range(3):
        want = ours(s)
        np.testing.assert_allclose([g["lr"] for g in opt.param_groups],
                                   [want, want * 0.1, want * 0.1], rtol=1e-12)
        opt.step()
        sched.step()


def test_dropout_keep_share_scale_and_seed():
    drop = Drop(0.1)
    x = torch.ones(400_000)
    drop.eval()
    assert drop(x, None) is x
    drop.train()
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        drop(x, None)
    a = drop(x, torch.Generator().manual_seed(3))
    b = drop(x, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.9) < 5 * (0.09 / x.numel()) ** 0.5
    assert torch.all(a[kept] == 1.0 / 0.9)  # inverted scaling


def test_feature_mask_keep_share_without_rescale(tiny):
    x = torch.ones(400_000)
    assert tiny._feature_mask(x, None) is x  # eval: off
    tiny.train()
    try:
        m = tiny._feature_mask(x, torch.Generator().manual_seed(4))
        assert torch.equal(m, tiny._feature_mask(x, torch.Generator().manual_seed(4)))
    finally:
        tiny.eval()
    assert set(m.unique().tolist()) == {0.0, 1.0}  # no 1/keep rescale
    assert abs(m.mean().item() - 0.7) < 5 * (0.21 / x.numel()) ** 0.5


def test_attention_dropout_is_one_mask_over_batch_and_heads(tiny):
    mha = tiny.transformer.decoder.layers[0].self_attn
    rng = np.random.default_rng(5)
    q1 = torch.from_numpy(rng.standard_normal((1, 12, 64)).astype(np.float32))
    v1 = torch.from_numpy(rng.standard_normal((1, 12, 64)).astype(np.float32))
    q, v = q1.expand(3, -1, -1), v1.expand(3, -1, -1)
    with torch.no_grad():
        # eval: the same function as torch's own multi-head attention
        ref = mha(q, q, v, need_weights=False)[0]
        np.testing.assert_allclose(self_attention(mha, q, v, 0.5, None).numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-6)
        mha.train()
        try:
            out = self_attention(mha, q, v, 0.5, torch.Generator().manual_seed(6))
            again = self_attention(mha, q, v, 0.5, torch.Generator().manual_seed(6))
        finally:
            mha.eval()
    assert torch.equal(out, again)
    assert not torch.allclose(out, ref)
    # identical batch rows stay identical: the mask is shared across the batch
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])
    # and it is one (Lq, Lk) mask for every head: rebuild it from the seed
    keep = torch.rand((12, 12), generator=torch.Generator().manual_seed(6)) < 0.5
    h, hd = mha.num_heads, 64 // mha.num_heads
    w_q, w_k, w_v = mha.in_proj_weight.detach().chunk(3)
    b_q, b_k, b_v = mha.in_proj_bias.detach().chunk(3)
    heads = lambda x, w, b: (x[0] @ w.T + b).view(12, h, hd).transpose(0, 1)
    att = torch.softmax((heads(q1, w_q, b_q) / hd ** 0.5) @ heads(q1, w_k, b_k).transpose(1, 2), -1)
    att = att * keep / 0.5
    want = mha.out_proj((att @ heads(v1, w_v, b_v)).transpose(0, 1).reshape(12, 64))
    np.testing.assert_allclose(out[0].numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-6)
