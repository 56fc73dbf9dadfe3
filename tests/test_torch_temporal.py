"""The port's temporal modules against the JAX package's, on the CPU.

`models/temporal/sequence.py` and `models/temporal/smoothnet.py` at small
widths: the JAX modules' parameters (drawn from numpy in the shapes of
their init, so no bias or `out_proj` is zero) cross to the port
through `train/convert.py` (`temporal_head_from_jax`,
`smoother_state_dict_from_jax`); inputs come from numpy with a seed. Held
within the fp32 tolerances of ROADMAP (1e-5 of the largest value for module
outputs, 1e-4 for heads and loss terms):
  - the BiLSTM, each direction apart, against flax's `LSTMCellScan` on the
    frames and on the reversed frames (the two directions' weights differ,
    so a swapped or transposed gate fails);
  - `TemporalAttention` at T = 5 of `max_window` 64 on activations whose
    variance is near the LayerNorm's eps; controls: the same weights with
    torch's default eps 1e-5, or with the exact GELU, must miss the
    tolerance;
  - `TemporalLSTMBlock`, and `TemporalParamHead` of both kinds on 10 rows
    at T = 4 (the rows padded with the last one and cut back);
  - `ArcticSmoother` in eval mode, and the gradient of a weighted sum of
    its outputs against `jax.grad`;
  - `inject_param_noise` with the JAX package's own draws injected
    (`apply_noise`), bit for bit, and the share of noised entries;
  - `smoothnet_loss` with a frame whose acceleration is NaN, and with no
    valid acceleration at all (the NaN-free mean's 0);
  - the smoother's dropout at the distribution level (rate 0.9: ~10 % kept,
    each scaled by 10), since the two packages' random streams differ.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvhand_tpu.models.temporal import sequence as jseq
from uvhand_tpu.models.temporal import smoothnet as jsm
from uvhand_tpu_torch.models.temporal import sequence, smoothnet
from uvhand_tpu_torch.train.convert import smoother_state_dict_from_jax, temporal_head_from_jax

from test_torch_model_options import assert_close
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

T = 4


def random_params(module, seed, *inputs):
    """Parameters of the flax `module` for `inputs`, drawn from numpy with
    `seed` in the shapes its init gives (`jax.eval_shape`: no init runs):
    kernels ~ N(0, 1 / fan_in), LayerNorm scales 1 + N(0, 0.1), every other
    leaf (biases, temporal positions) ~ N(0, 0.1); no leaf is zero."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            v = rng.normal(scale=leaf.shape[0] ** -0.5, size=leaf.shape)
        else:
            v = (name == "scale") + rng.normal(scale=0.1, size=leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def selected_params(rows, seed=0):
    rng = np.random.default_rng(seed)
    sel = {k: rng.normal(size=(rows, d)).astype(np.float32) for k, d in sequence.PARAM_SPECS}
    sel["obj_rad"] = sel["obj_rad"][:, 0]
    return sel


def torch_dict(sel):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sel.items()}


def loaded(module, state_dict):
    module.load_state_dict(state_dict)
    return module.eval()


def test_each_lstm_direction_equals_flax_on_its_frames():
    xs = np.random.default_rng(1).normal(size=(3, 6, 8)).astype(np.float32)
    bi = jseq.BiLSTM(5)
    p = random_params(bi, 2, xs)
    assert not np.allclose(p["fwd"]["OptimizedLSTMCell_0"]["hi"]["kernel"],
                           p["bwd"]["OptimizedLSTMCell_0"]["hi"]["kernel"])
    # the converter maps a block: wrap the BiLSTM in one with identity projections
    eye = {"kernel": np.eye(8, dtype=np.float32), "bias": np.zeros(8, np.float32)}
    sd = temporal_head_from_jax({"ta": {"in_proj": eye, "bilstm": p, "out_proj": {
        "kernel": np.zeros((10, 8), np.float32), "bias": np.zeros(8, np.float32)}}}, "h")
    ours = sequence.BiLSTM(8, 5)
    ours.load_state_dict({k[len("h.ta.bilstm."):]: v for k, v in sd.items() if ".bilstm." in k})
    out = ours(torch.from_numpy(xs)).detach()
    cell = jseq.LSTMCellScan(5)  # one direction: its tree is {OptimizedLSTMCell_0: ...}
    fwd = cell.apply({"params": p["fwd"]}, xs)
    bwd = np.asarray(cell.apply({"params": p["bwd"]}, xs[:, ::-1]))[:, ::-1]
    ref = np.asarray(bi.apply({"params": p}, xs))
    assert_close(out[..., :5], fwd, 1e-5, "forward direction")
    assert_close(out[..., 5:], bwd, 1e-5, "backward direction")
    assert_close(out, ref, 1e-5, "BiLSTM")
    assert not ours.lstm.bias_ih_l0.requires_grad and not ours.lstm.bias_ih_l0.any()


def attention_case():
    rng = np.random.default_rng(4)
    # activations of variance ~1e-5, near the LayerNorm's eps of 1e-6
    xs = (rng.normal(size=(2, 5, 3)) * 1e-3).astype(np.float32)
    jmod = jseq.TemporalAttention(16, heads=4)
    p = random_params(jmod, 5, xs)
    p = dict(p, temporal_pos=p["temporal_pos"] * 1e-2, in_proj=dict(
        kernel=p["in_proj"]["kernel"] * 1e-2, bias=p["in_proj"]["bias"] * 1e-2))
    sd = temporal_head_from_jax({"ta": p}, "h")
    return xs, np.asarray(jmod.apply({"params": p}, xs)), {
        k[len("h.ta."):]: v for k, v in sd.items()}


def test_temporal_attention_equals_flax_and_its_controls_fail():
    xs, ref, sd = attention_case()
    ours = loaded(sequence.TemporalAttention(3, 16), sd)
    assert ours.temporal_pos.shape == (64, 16)
    assert_close(ours(torch.from_numpy(xs)).detach(), ref, 1e-5, "TemporalAttention")
    for ln in (*ours.ln1, *ours.ln2):
        ln.eps = 1e-5  # torch's default
    with pytest.raises(AssertionError):
        assert_close(ours(torch.from_numpy(xs)).detach(), ref, 1e-5, "eps 1e-5")
    exact = loaded(sequence.TemporalAttention(3, 16), sd)
    gelu = sequence.F.gelu
    try:
        sequence.F.gelu = lambda x, approximate="none": gelu(x)
        with pytest.raises(AssertionError):
            assert_close(exact(torch.from_numpy(xs)).detach(), ref, 1e-5, "exact GELU")
    finally:
        sequence.F.gelu = gelu


def test_lstm_block_equals_flax():
    xs = np.random.default_rng(6).normal(size=(3, T, 10)).astype(np.float32)
    jmod = jseq.TemporalLSTMBlock(16)
    p = random_params(jmod, 7, xs)
    sd = temporal_head_from_jax({"ta": p}, "h")
    ours = loaded(sequence.TemporalLSTMBlock(10, 16), {k[len("h.ta."):]: v for k, v in sd.items()})
    assert_close(ours(torch.from_numpy(xs)).detach(), jmod.apply({"params": p}, xs), 1e-5,
                 "TemporalLSTMBlock")


@pytest.mark.parametrize("kind", ["lstm", "vivit"])
def test_param_head_pads_rows_to_whole_windows_as_flax(kind):
    sel = selected_params(10)  # 10 rows: two windows of 4 and a padded one
    jhead = jseq.TemporalParamHead(T, dim=16, kind=kind)
    p = random_params(jhead, 8, sel)
    ref = jax.jit(jhead.apply)({"params": p}, sel)
    sd = temporal_head_from_jax(p, "h")
    ours = loaded(sequence.TemporalParamHead(T, dim=16, kind=kind),
                  {k[len("h."):]: v for k, v in sd.items()})
    out = ours(torch_dict(sel))
    for name, _ in sequence.PARAM_SPECS:
        assert_close(out[name].detach(), ref[name], 1e-5, name)
    # a fresh head is the identity (zero out_proj)
    fresh = sequence.TemporalParamHead(T, dim=16, kind=kind)
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(fresh(torch_dict(sel))[k], torch.from_numpy(sel[k])) for k in sel)


@pytest.fixture(scope="module")
def smoother_case():
    """A window-5 ArcticSmoother, random JAX parameters, 2 windows of
    selected parameters, a weighting of the outputs, and JAX's eval-mode
    outputs (float32) and gradient of the weighted sum (float64: the
    gradient sums run through 3 residual blocks of 512 units, and float32
    alone strays ~1e-3 of a tensor's max from float64 in either package)."""
    sel = selected_params(10, 9)
    jmod = jsm.ArcticSmoother(5)
    p = random_params(jmod, 10, sel)
    w = {k: np.random.default_rng(11).normal(size=v.shape) for k, v in sel.items()}

    def objective(params, sel):
        out = jmod.apply({"params": params}, sel)
        return sum(jnp.sum(out[k] * w[k]) for k in w)

    ref = jmod.apply({"params": p}, sel)
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(lambda v: np.asarray(v, np.float64), t)  # noqa: E731
        grads = jax.tree.map(np.asarray, jax.jit(jax.grad(objective))(f64(p), f64(sel)))
    return sel, w, p, ref, grads


def test_arctic_smoother_and_its_gradient_equal_jax(smoother_case):
    sel, w, p, ref, grads = smoother_case
    ours = loaded(smoothnet.ArcticSmoother(5), smoother_state_dict_from_jax(p))
    out = ours(torch_dict(sel))
    for k in sel:
        assert_close(out[k].detach(), ref[k], 1e-5, k)
    ours.double()
    out = ours({k: v.double() for k, v in torch_dict(sel).items()})
    sum(torch.sum(out[k] * torch.from_numpy(w[k])) for k in w).backward()
    want = smoother_state_dict_from_jax(grads)  # float64 gradients, rounded to float32
    got = dict(ours.named_parameters())
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        assert_close(got[name].grad, g.numpy(), 1e-6, name)


def test_the_smoother_needs_a_window_of_three():
    with pytest.raises(ValueError, match="window_size >= 3"):
        smoothnet.ArcticSmoother(2)


def test_noise_with_jaxs_draws_equals_jax():
    sel = selected_params(40, 12)
    key = jax.random.PRNGKey(13)
    ref = jsm.inject_param_noise(key, {k: jnp.asarray(v) for k, v in sel.items()}, 0.3)
    draws = {}
    for i, k in enumerate(smoothnet.NOISE_SCALES):
        r = jax.random.fold_in(key, i)
        shape = sel[k].shape
        draws[k] = (torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(r, 0),
                                                                   shape))),
                    torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(r, 1),
                                                                  shape))))
    out = smoothnet.apply_noise(torch_dict(sel), draws, 0.3)
    for k in sel:
        assert np.array_equal(out[k].numpy(), np.asarray(ref[k])), k
    # the port's own draws noise a share p_mask of the entries, obj_rot by ~5
    big = selected_params(4000, 14)
    ours = smoothnet.inject_param_noise(torch.Generator().manual_seed(0), torch_dict(big), 0.05)
    moved_ = np.concatenate([(ours[k].numpy() != big[k]).ravel() for k in big])
    assert abs(moved_.mean() - 0.05) < 0.005
    rot = ours["obj_rot"].numpy() - big["obj_rot"]
    assert 4.0 < rot[rot != 0].std() < 6.0


def decoded_frames(n, seed, invalid=()):
    """Decoded camera-space predictions and targets of n frames, as the
    smoothnet loss reads them (hands of 778 vertices, objects of 40)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32) * 0.05  # noqa: E731
    is_valid = np.ones(n, np.float32)
    is_valid[list(invalid)] = 0.0
    pred = {"object.v.cam": f(n, 40, 3), "mano.v3d.cam.r": f(n, 778, 3),
            "mano.v3d.cam.l": f(n, 778, 3), "mano.j3d.cam.r": f(n, 21, 3),
            "mano.j3d.cam.l": f(n, 21, 3)}
    gt = {k: v + f(*v.shape) * 0.1 for k, v in pred.items()}
    gt.update({"object.parts_ids": rng.integers(1, 3, size=(n, 40)).astype(np.int32),
               "is_valid": is_valid, "left_valid": np.ones(n, np.float32),
               "right_valid": (rng.uniform(size=n) > 0.2).astype(np.float32),
               "dist.ro": rng.uniform(0, 0.006, size=(n, 778)).astype(np.float32),
               "dist.lo": rng.uniform(0, 0.006, size=(n, 778)).astype(np.float32),
               "idx.ro": rng.integers(0, 40, size=(n, 778)).astype(np.int32),
               "idx.lo": rng.integers(0, 40, size=(n, 778)).astype(np.int32)})
    return pred, gt


@pytest.mark.parametrize("invalid", [(3,), tuple(range(8))], ids=["one_nan_frame", "all_nan"])
def test_smoothnet_loss_equals_jax(invalid):
    pred, gt = decoded_frames(8, 15, invalid)
    _, ref = jsm.smoothnet_loss({k: jnp.asarray(v) for k, v in pred.items()},
                                {k: jnp.asarray(v) for k, v in gt.items()})
    total, ours = smoothnet.smoothnet_loss(torch_dict(pred), torch_dict(gt))
    assert sorted(ours) == sorted(ref) == ["acc/h", "acc/o", "loss/cd", "total"]
    for k, v in ref.items():
        v = float(v)
        assert np.isfinite(float(ours[k])), k
        assert abs(float(ours[k]) - v) <= 1e-4 * max(abs(v), 1e-3), (k, float(ours[k]), v)
    if len(invalid) == 8:
        assert float(ours["acc/h"]) == float(ours["acc/o"]) == 0.0
    assert total is ours["total"]


def test_the_smoothers_dropout_keeps_a_tenth_scaled_by_ten():
    block = smoothnet.SmootherResBlock(4)
    block.train()
    x = torch.ones(200_000)
    y = block.drop(x, torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) == {0.0, 10.0}
    assert abs(float((y > 0).float().mean()) - 0.1) < 0.003
    sm = smoothnet.ArcticSmoother(5, generator=torch.Generator().manual_seed(0)).train()
    sel = torch_dict(selected_params(10, 16))
    runs = [sm(sel, torch.Generator().manual_seed(s))["pose.l"] for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    sm.eval()
    assert torch.equal(sm(sel)["pose.l"], sm(sel, torch.Generator().manual_seed(3))["pose.l"])
