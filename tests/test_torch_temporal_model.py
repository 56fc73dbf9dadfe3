"""The port's temporal variant end to end against the JAX package's, on the
CPU.

A tiny two-stage box-refine DETR (1 encoder and 1 decoder layer, d=32, 4
heads, 12 queries, dropout 0, feature mask 0) at 128x128 with each temporal
head (`lstm`, `vivit`) over windows of T = 4 frames, on one synthetic ARCTIC
sequence of 8 frames with random images: the port's seeded weights (random
MSDA offset/attention kernels) go to JAX through `convert_reference_detr`,
the head's are drawn for the JAX tree (`test_torch_temporal.random_params`,
nonzero `out_proj`), and the whole tree comes back to the port through
`state_dict_from_jax`. One jitted JAX function per head gives the loss
dict and `jax.grad` of one train step on 2 `TempoTrainDataset` windows, the
lstm model's with `split_window` true (every frame's targets), the vivit
model's with it false (the centre frames', `center_index`); one JAX
compile per head: the suite is near its time limit.
Held: the model's `temporal_selected` and the `<name>/temporal` loss keys;
every loss within 1e-4; the gradients of every parameter outside the
backbone (the temporal head's included) within 1e-3 of each tensor's max, as
`test_torch_dino_model.py` holds them (the backbone's gradient, which the
single-frame A/Bs hold, is not taken: XLA then builds no ResNet-50
backward, which halves the compile);
both models' eval steps decode the refined parameters (their metrics are
those of `temporal_selected`, not of the last layer's selection), the lstm
model's on 2 `WindowDataset` windows within the eval A/B's 1e-2 mm + 1e-4
relative of JAX's decode and metrics of the same parameters.

SmoothNet (on the lstm model as its frozen base, window 4): the smoothnet
loss and its gradient in the smoother's parameters, with the smoother in
eval mode (no dropout) and JAX's own noise draws injected, against the JAX
package's pieces of `make_smoothnet_train_step`'s loss (`inject_param_noise`,
the smoother, `decode_predictions`, `smoothnet_loss`, on the port's frozen
base selection and targets, which the A/Bs above hold), the losses within
1e-4 and the gradient as `assert_smoother_grads` says; then one
`make_smoothnet_train_step` step with the same draws and dropout 0: its
gradient equals JAX's, its
AdamW update equals `optax.adamw(lr)` (its defaults: b1 0.9, b2 0.999, eps
1e-8, weight decay 1e-4) applied to the same gradient, and the base model
does not move; and `make_smoothnet_eval_step`'s metrics against JAX's
decode and metrics of the eval-mode smoother's output.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from uvhand_tpu import engine as jengine
from uvhand_tpu.evaluation.decode import decode_predictions as jdecode
from uvhand_tpu.evaluation.metrics import measure_error as jmeasure_error
from uvhand_tpu.geometry import mano as jmano
from uvhand_tpu.geometry import objects as jobjects
from uvhand_tpu.models.detr import UVHandDETR as JaxDETR
from uvhand_tpu.models.temporal import sequence as jseq
from uvhand_tpu.models.temporal import smoothnet as jsm
from uvhand_tpu.train.convert import convert_reference_detr
from uvhand_tpu_torch import engine
from uvhand_tpu_torch.data import arctic
from uvhand_tpu_torch.geometry import mano, objects
from uvhand_tpu_torch.losses.criterion import compute_small_loss, select_queries
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.models.temporal import sequence, smoothnet
from uvhand_tpu_torch.train import smoothnet_driver
from uvhand_tpu_torch.train.convert import smoother_state_dict_from_jax, state_dict_from_jax
from uvhand_tpu_torch.train.state import label_params

from test_torch_dino_model import tree_np
from test_torch_temporal import random_params
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

RES, T = 128, 4
CFG = dict(num_queries=12, num_encoder_layers=1, num_decoder_layers=1, d_model=32, n_heads=4,
           dim_feedforward=64, dropout=0.0, feature_mask_ratio=0.0, two_stage=True,
           with_box_refine=True)
KINDS = ("lstm", "vivit")
#: the train batch of each head: every frame's targets, or the centre frames'
SPLITS = {"lstm": "split", "vivit": "centre"}
LR = 1e-2  # large enough that a wrong weight decay moves a parameter by ~1e-5


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Window batches of one 8-frame sequence (2 windows of 4, random
    images): `TempoTrainDataset` with split_window true and false (the same
    frames) and `WindowDataset`."""
    root = str(tmp_path_factory.mktemp("arctic"))
    bank = jobjects.synthetic_object_bank(2)
    arctic.make_synthetic_root(root, num_seqs=1, frames=8, views=1, seed=1, image_hw=(150, 210),
                               obj_bank=objects.synthetic_object_bank(2, device="cpu"))
    ds = arctic.ArcticDataset(root, "p1", "train", two_stage=True, img_res=RES,
                              kp3d_cano=np.asarray(bank.kp_bottom))
    images = np.random.default_rng(3).uniform(-2.0, 2.0, (2 * T, RES, RES, 3)).astype(np.float32)
    batches = {}
    for split in (True, False):
        tds = arctic.TempoTrainDataset(ds, T, split_window=split)
        b = arctic.collate_tempo_train([tds[2], tds[5]], split_window=split)
        batches["split" if split else "centre"] = dict(b, images=images)
    wds = arctic.WindowDataset(ds, T)
    batches["windows"] = dict(arctic.collate_windows([wds[0], wds[1]]), images=images)
    jworld = (jmano.synthetic_mano(0, True), jmano.synthetic_mano(1, False), bank)
    tworld = (mano.synthetic_mano(0, True, device="cpu"),
              mano.synthetic_mano(1, False, device="cpu"),
              objects.synthetic_object_bank(2, device="cpu"))
    return batches, jworld, tworld


def models(kind, selected):
    """(the port's model with the `kind` head, the JAX tree it holds): the
    port's seeded weights with random MSDA kernels, the head's drawn for
    the JAX tree, and the whole tree loaded back into the port."""
    port = UVHandDETR(**CFG, temporal_head=kind, temporal_window=T,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith(("sampling_offsets.weight", "attention_weights.weight")):
                p.copy_(torch.from_numpy(rng.normal(scale=0.05, size=p.shape).astype(np.float32)))
    variables = convert_reference_detr(port.state_dict(), num_decoder_layers=1,
                                       num_encoder_layers=1, n_heads=4, two_stage=True)
    variables["params"]["temporal_param_head"] = random_params(
        jseq.TemporalParamHead(T, kind=kind), 20 + KINDS.index(kind), selected)
    before = port.state_dict()
    port.load_state_dict(state_dict_from_jax(variables))
    for k, v in port.state_dict().items():
        if not k.startswith("temporal_param_head."):
            assert torch.equal(v, before[k]), k
    return port, variables


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def run_kind(kind, data, port, variables):
    """For the `kind` model, one jitted JAX function: the loss dict and
    gradients of one train step on its batch (`SPLITS`)."""
    batches, jworld, tworld = data
    jmodel = JaxDETR(**CFG, temporal_head=kind, temporal_window=T)
    loss_fn = jengine.make_loss_fn(jmodel, *jworld, img_res=float(RES))

    def rest_loss(rest, backbone, batch):
        return loss_fn({**rest, "backbone": backbone}, batch, jax.random.PRNGKey(5))

    @jax.jit
    def jrun(params, train):
        # the backbone's gradient is not taken (held by the single-frame
        # tests), so XLA builds no backward of the ResNet-50
        rest = {k: v for k, v in params.items() if k != "backbone"}
        (_, ld), grads = jax.value_and_grad(rest_loss, has_aux=True)(
            rest, params["backbone"], train)
        return ld, grads

    ld, grads = jrun(variables["params"], jax_batch(batches[SPLITS[kind]]))
    return dict(kind=kind, split=SPLITS[kind], port=port, variables=variables,
                j_ld={k: float(v) for k, v in ld.items()},
                j_grads={k: v.numpy() for k, v in state_dict_from_jax(dict(
                    grads, backbone=variables["params"]["backbone"])).items()
                    if not k.startswith("backbone.")})


def port_base(port, data):
    """The port's eval-mode outputs of the window batch as JAX arrays: its
    frozen base selection (`smoothnet_driver.base_selected`), its targets
    and its temporal head's refined parameters."""
    batch = engine.to_device(data[0]["windows"], "cpu")
    targets, base = smoothnet_driver.base_selected(port, batch, *data[2], float(RES))
    with torch.no_grad():
        refined = port(batch["images"])["temporal_selected"]
    return tuple({k: jnp.asarray(v.numpy()) for k, v in d.items()}
                 for d in (base, targets, refined))


def run_smoothnet(data, base, targets, refined):
    """JAX's smoothnet loss and gradient in the smoother's parameters on a
    base model's selected queries and targets (the queries are constants of
    the loss, as the JAX step's `stop_gradient` makes them), the smoother in
    eval mode, the noise of one key; the noise's draws; and the eval steps'
    metrics (`decode_predictions`, `measure_error`, as `jengine.
    make_eval_step` and `make_smoothnet_eval_step` take them) of the
    `refined` parameters and of the smoothed base selection."""
    jworld = data[1]
    smoother = jsm.ArcticSmoother(T)
    sm_params = random_params(smoother, 30, base)
    key = jax.random.PRNGKey(9)

    def loss_fn(sm_params, base, targets):
        noised = jsm.inject_param_noise(key, base, 0.05)
        smoothed = smoother.apply({"params": sm_params}, noised, train=False)
        return jsm.smoothnet_loss(jdecode(smoothed, targets, *jworld, float(RES)), targets)

    @jax.jit
    def jrun(sm_params, base, targets, refined):
        def metrics(selected):  # the eval steps' decode and metrics
            return jmeasure_error(jdecode(selected, targets, *jworld, float(RES)), targets,
                                  jengine.BATCH_METRICS)

        smoothed = smoother.apply({"params": sm_params}, base, train=False)
        return (jax.value_and_grad(loss_fn, has_aux=True)(sm_params, base, targets),
                metrics(refined), metrics(smoothed))

    ((_, ld), grads), metrics, sm_metrics = jrun(sm_params, base, targets, refined)
    draws = {}
    for i, (k, _) in enumerate(noised_specs()):
        r, shape = jax.random.fold_in(key, i), base[k].shape
        draws[k] = tuple(torch.from_numpy(np.array(f(jax.random.fold_in(r, j), shape)))
                         for j, f in enumerate((jax.random.uniform, jax.random.normal)))
    return dict(sm_params=sm_params, j_ld={k: float(v) for k, v in ld.items()},
                j_grads={k: v.numpy() for k, v in smoother_state_dict_from_jax(grads).items()},
                draws=draws, j_metrics=tree_np(metrics), j_sm_metrics=tree_np(sm_metrics))


def noised_specs():
    """The noised parameters in `NOISE_SCALES` order, with their widths."""
    widths = dict(sequence.PARAM_SPECS)
    return [(k, widths[k]) for k in smoothnet.NOISE_SCALES]


@pytest.fixture(scope="module")
def jax_runs(data):
    """Both heads' JAX runs and the smoothnet run (on the port's lstm model's
    window-batch selection: the base forward and `select_queries` are held
    above), compiled at once in three threads (XLA compiles outside the
    interpreter lock)."""
    zeros = {k: np.zeros((2 * T, d) if d > 1 else (2 * T,), np.float32)
             for k, d in noised_specs()}
    built = {k: models(k, zeros) for k in KINDS}
    with ThreadPoolExecutor(3) as pool:  # the lstm model is the smoothnet's base
        runs = {k: pool.submit(run_kind, k, data, *built[k]) for k in KINDS}
        runs["smoothnet"] = pool.submit(run_smoothnet, data, *port_base(built["lstm"][0], data))
        return {k: f.result() for k, f in runs.items()}


def port_step(port, batch, tworld):
    """The port's loss dict and raw gradients of one train-mode loss."""
    port.train()
    port.zero_grad()
    loss_fn = engine.make_loss_fn(port, *tworld, img_res=float(RES))
    total, ld = loss_fn(engine.to_device(batch, "cpu", engine.TRAIN_KEYS), None)
    total.backward()
    port.eval()
    return ({k: float(v.detach()) for k, v in ld.items()},
            {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
             for n, p in port.named_parameters()})


@pytest.fixture(scope="module", params=KINDS)
def kind_run(request, data, jax_runs):
    run = jax_runs[request.param]
    if "t_ld" not in run:
        run["t_ld"], run["t_grads"] = port_step(run["port"], data[0][run["split"]], data[2])
    return run


def test_the_model_gives_refined_parameters_and_their_losses(kind_run, data):
    port = kind_run["port"]
    with torch.no_grad():
        out = port(torch.from_numpy(data[0]["windows"]["images"]))
    sel = out["temporal_selected"]
    plain = select_queries({k: v[-1] for k, v in out["stacked"].items()})
    assert sel["pose.l"].shape == (2 * T, 48) and sel["obj_rad"].shape == (2 * T,)
    assert not torch.allclose(sel["pose.l"], plain["pose.l"])  # the head moved them
    assert torch.equal(sel["query.l"], plain["query.l"])
    batch = engine.to_device(data[0]["windows"], "cpu", engine.TRAIN_KEYS)
    small = compute_small_loss(plain, engine.process_targets(batch, *data[2], float(RES)),
                               *data[2], float(RES))
    keys = set(kind_run["t_ld"])
    assert {f"{k}/temporal" for k in small} <= keys
    assert set(kind_run["j_ld"]) == keys


def test_train_step_losses_and_gradients_equal_jax(kind_run):
    """lstm on every frame's targets, vivit on the centre frames'."""
    ours, ref = kind_run["t_ld"], kind_run["j_ld"]
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
    labels = label_params(kind_run["port"])
    jgrads = kind_run["j_grads"]
    grads = {n: g for n, g in kind_run["t_grads"].items() if labels[n] != "backbone"}
    assert set(grads) <= set(jgrads) and not any(n.startswith("backbone") for n in jgrads)
    # with d=32 each GroupNorm group is one channel, so the input projections'
    # conv biases, which it subtracts out, have no gradient: both packages
    # give rounding noise there, held below 1e-5 of the conv weights' gradient
    nulled = [f"input_proj.{i}.0.bias" for i in range(4)]
    for n in nulled:
        top = np.abs(jgrads[n.replace("bias", "weight")]).max()
        assert max(np.abs(grads[n]).max(), np.abs(jgrads[n]).max()) <= 1e-5 * top, n
    bad = [n for n, g in grads.items() if n not in nulled
           and np.abs(g - jgrads[n]).max() > 1e-3 * max(np.abs(jgrads[n]).max(), 1e-30)]
    assert not bad, bad
    head = [n for n in grads if n.startswith("temporal_param_head.") and "bias_ih" not in n]
    assert head and all(np.abs(jgrads[n]).max() > 0 for n in head)


def test_the_centre_batch_holds_its_centre_frames(data):
    """split_window false: B = 2 targets against 8 frames, picked by
    `center_index`, one row of each window."""
    centre = data[0]["centre"]
    assert centre["is_valid"].shape == (2,) and centre["images"].shape[0] == 2 * T
    assert (centre["center_index"] // T).tolist() == [0, 1]
    split = data[0]["split"]
    for k in ("mano.pose.r", "object.rot", "labels"):
        assert np.array_equal(centre[k], split[k][centre["center_index"]]), k


def test_eval_decodes_the_refined_parameters_as_jax(jax_runs, data):
    """Both models' eval steps decode their refined parameters, not the last
    layer's selection; the lstm model's metrics equal JAX's decode and
    metrics of its refined parameters (which the train steps' `/temporal`
    losses hold against JAX's: with dropout and the feature mask at 0 the
    train forward is the eval forward)."""
    for kind in KINDS:
        port = jax_runs[kind]["port"]
        step = engine.make_eval_step(port, *data[2], float(RES), device="cpu")
        ours = {k: v.numpy() for k, v in step(data[0]["windows"]).items()}
        batch = engine.to_device(data[0]["windows"], "cpu")
        with torch.no_grad():
            targets = engine.process_targets(batch, *data[2], float(RES))
            out = port(batch["images"])
            refined, plain = (engine.measure_error(engine.decode_predictions(
                sel, targets, *data[2], float(RES)), targets) for sel in (
                out["temporal_selected"],
                select_queries({k: v[-1] for k, v in out["stacked"].items()})))
        for k, v in ours.items():
            assert np.array_equal(v, refined[k].numpy(), equal_nan=True), k
        assert any(not np.array_equal(v, plain[k].numpy(), equal_nan=True)
                   for k, v in ours.items())
    assert_metrics(engine.make_eval_step(jax_runs["lstm"]["port"], *data[2], float(RES),
                                         device="cpu")(data[0]["windows"]),
                   jax_runs["smoothnet"]["j_metrics"])


def assert_metrics(ours, ref):
    """Per-frame metrics within the eval A/B's 1e-2 mm + 1e-4 relative, NaN
    where JAX's are."""
    ours = {k: v.numpy() for k, v in ours.items()}
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert np.array_equal(np.isnan(ours[k]), np.isnan(v)), k
        ok = ~np.isnan(v)
        assert np.all(np.abs(ours[k][ok] - v[ok]) <= 1e-2 + 1e-4 * np.abs(v[ok])), k


def test_smoothnet_eval_step_equals_jaxs_pieces(jax_runs, data):
    """`make_smoothnet_eval_step`: the frozen base, the smoother in eval mode
    (no noise, no dropout), decode and the per-frame metrics."""
    smoother = smoothnet.ArcticSmoother(T)
    smoother.load_state_dict(smoother_state_dict_from_jax(jax_runs["smoothnet"]["sm_params"]))
    step = smoothnet_driver.make_smoothnet_eval_step(jax_runs["lstm"]["port"], smoother,
                                                     *data[2], float(RES), device="cpu")
    assert_metrics(step(data[0]["windows"]), jax_runs["smoothnet"]["j_sm_metrics"])


def assert_smoother_grads(grads, ref):
    """The smoother's gradient against JAX's: its relative L2 error within
    1e-4, and each tensor within 1e-3 of the gradient's largest entry. The
    acceleration terms reach the shape smoother through second differences
    of MANO vertices across frames, whose float32 cancellation moves its
    small gradients by up to ~1e-2 of their own max with the summation
    order (torch's thread count alone does it)."""
    assert sorted(grads) == sorted(ref)
    err = sum(float(np.sum((g - ref[n]).astype(np.float64) ** 2)) for n, g in grads.items())
    norm = sum(float(np.sum(r.astype(np.float64) ** 2)) for r in ref.values())
    assert np.sqrt(err / norm) <= 1e-4, np.sqrt(err / norm)
    top = max(float(np.abs(r).max()) for r in ref.values())
    for n, g in grads.items():
        assert np.abs(g - ref[n]).max() <= 1e-3 * top, n


def test_smoothnet_loss_and_gradient_equal_jaxs_pieces(jax_runs, data):
    sm, base = jax_runs["smoothnet"], jax_runs["lstm"]["port"]
    batches, _, tworld = data
    smoother = smoothnet.ArcticSmoother(T)
    smoother.load_state_dict(smoother_state_dict_from_jax(sm["sm_params"]))
    smoother.eval()
    batch = engine.to_device(batches["windows"], "cpu")
    targets, selected = smoothnet_driver.base_selected(base, batch, *tworld, float(RES))
    noised = smoothnet.apply_noise(selected, sm["draws"], 0.05)
    assert any(not torch.equal(noised[k], selected[k]) for k in selected)
    pred = engine.decode_predictions(smoother(noised), targets, *tworld, float(RES))
    total, ld = smoothnet.smoothnet_loss(pred, targets)
    for k, v in sm["j_ld"].items():
        np.testing.assert_allclose(float(ld[k].detach()), v, rtol=1e-4, atol=1e-6, err_msg=k)
    total.backward()
    assert_smoother_grads({n: p.grad.numpy() for n, p in smoother.named_parameters()},
                          sm["j_grads"])


def test_a_smoothnet_step_is_optaxs_adamw_on_the_same_gradient(jax_runs, data, monkeypatch):
    sm, base = jax_runs["smoothnet"], jax_runs["lstm"]["port"]
    batches, _, tworld = data
    smoother, opt = smoothnet_driver.create_smoother_state(T, lr=LR, device="cpu")
    smoother.load_state_dict(smoother_state_dict_from_jax(sm["sm_params"]))
    for mod in smoother.modules():  # dropout 0: train mode draws nothing
        if isinstance(mod, smoothnet.Drop):
            mod.rate = 0.0
    monkeypatch.setattr(smoothnet_driver, "inject_param_noise",
                        lambda g, selected, p: smoothnet.apply_noise(selected, sm["draws"], p))
    base_before = {k: v.clone() for k, v in base.state_dict().items()}
    old = {n: p.detach().clone() for n, p in smoother.named_parameters()}
    step = smoothnet_driver.make_smoothnet_train_step(base, smoother, opt, *tworld,
                                                      img_res=float(RES), device="cpu")
    ld = step(batches["windows"])
    np.testing.assert_allclose(float(ld["total"]), sm["j_ld"]["total"], rtol=1e-4)
    grads = {n: p.grad.numpy() for n, p in smoother.named_parameters()}
    assert_smoother_grads(grads, sm["j_grads"])
    # optax.adamw(LR) (its defaults) on the same gradient and parameters
    params = {n: jnp.asarray(v.numpy()) for n, v in old.items()}
    tx = optax.adamw(LR)
    new = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        {n: jnp.asarray(g) for n, g in grads.items()}, params)
    for n, p in smoother.named_parameters():
        d = float(np.abs(p.detach().numpy() - np.asarray(new[n])).max())
        assert d <= 1e-6, (n, d)
        assert not torch.equal(p, old[n]), n
    for k, v in base.state_dict().items():
        assert torch.equal(v, base_before[k]), k


def test_the_temporal_head_needs_a_window_as_the_jax_model_does():
    with pytest.raises(ValueError, match="unknown temporal_head 'gru'"):
        UVHandDETR(**CFG, temporal_head="gru", temporal_window=4, device="cpu")
    with pytest.raises(ValueError, match="needs temporal_window > 1"):
        UVHandDETR(**CFG, temporal_head="lstm", temporal_window=1, device="cpu")
    with pytest.raises(AssertionError, match="temporal_window"):
        jax.eval_shape(JaxDETR(**CFG, temporal_head="lstm", temporal_window=1).init,
                       jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)))
