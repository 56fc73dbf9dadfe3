"""The port's serving slice against the JAX package's, end to end.

One batch of a synthetic ARCTIC root whose object GT is self-consistent with
the object bank (`make_synthetic_root(obj_bank=...)`, read by the JAX
package's `ArcticDataset`, which the port does not have yet) goes through
`process_targets`, the model, `select_queries`, `decode_predictions` and the
per-frame metrics of `make_eval_step` (the JAX step's body, jitted once with
its intermediates returned), in both packages, with the port's
weights carried to the JAX tree by `convert_reference_detr`.

Tolerances: GT tensors 1e-5 m and predictions 1e-5 (float32 rounding of the
same arithmetic in another order, on values below ~1 m). The nearest-point
distances come from |s|^2 + |d|^2 - 2 s.d with |s|^2 ~ 0.4 m^2, so they are
compared squared, to 5e-7 m^2 (a few float32 ulps of 0.4), and a nearest
index may differ only where both picks are that close (a near tie). Metric rows
1e-2 mm + 1e-4 relative, since the metrics take differences of
camera-space points ~0.6 m from the camera and scale them by 1000.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvhand_tpu import engine as jengine
from uvhand_tpu.data import arctic
from uvhand_tpu.data.process import process_targets as jprocess
from uvhand_tpu.evaluation.decode import decode_predictions as jdecode
from uvhand_tpu.evaluation.metrics import measure_error as jmeasure
from uvhand_tpu.geometry import mano as jmano
from uvhand_tpu.geometry import objects as jobjects
from uvhand_tpu.losses.criterion import select_queries as jselect
from uvhand_tpu.models.detr import UVHandDETR as JaxDETR
from uvhand_tpu.train.convert import convert_reference_detr
from uvhand_tpu_torch import engine
from uvhand_tpu_torch.data.process import process_targets
from uvhand_tpu_torch.evaluation.decode import decode_predictions
from uvhand_tpu_torch.geometry import mano, objects
from uvhand_tpu_torch.losses.criterion import select_queries
from uvhand_tpu_torch.models.detr import UVHandDETR

from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(num_queries=12, num_encoder_layers=1, num_decoder_layers=2, d_model=64,
           n_heads=4, dim_feedforward=128)


def _close(name, ours, ref, atol, rtol=0.0):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    if ref.dtype.kind in "iub":
        np.testing.assert_array_equal(ours, ref, err_msg=name)
    else:
        np.testing.assert_allclose(ours, ref, atol=atol, rtol=rtol, err_msg=name)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("arctic"))
    jbank = jobjects.synthetic_object_bank(2)
    arctic.make_synthetic_root(root, num_seqs=1, frames=4, views=1, obj_bank=jbank)
    ds = arctic.ArcticDataset(root, "p1", "train", aug=False,
                              kp3d_cano=np.asarray(jbank.kp_bottom))
    batch = arctic.collate([ds[i] for i in range(4)])

    port = UVHandDETR(**CFG, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    sd = port.state_dict()
    for k, v in sd.items():
        if k.endswith(("sampling_offsets.weight", "attention_weights.weight")):
            v.copy_(torch.from_numpy(rng.normal(scale=0.05, size=v.shape).astype(np.float32)))
    variables = convert_reference_detr(sd, num_decoder_layers=2, num_encoder_layers=1,
                                       n_heads=4)
    jax_model = JaxDETR(**CFG, dropout=0.0, feature_mask_ratio=0.0)
    return {
        "batch": batch, "port": port, "jax_model": jax_model, "variables": variables,
        "jax": (jmano.synthetic_mano(0, True), jmano.synthetic_mano(1, False), jbank),
        "torch": (mano.synthetic_mano(0, True, device="cpu"),
                  mano.synthetic_mano(1, False, device="cpu"),
                  objects.synthetic_object_bank(2, device="cpu")),
    }


def test_process_targets_matches_jax(world):
    tb = engine.to_device(world["batch"], "cpu")
    ours = process_targets(tb, *world["torch"])
    ref = jax.jit(lambda b: jprocess(b, *world["jax"]))(
        {k: jnp.asarray(v) for k, v in world["batch"].items()})
    pairs = {"ro": ("mano.v3d.cam.r", "object.v.cam"), "lo": ("mano.v3d.cam.l", "object.v.cam"),
             "or": ("object.v.cam", "mano.v3d.cam.r"), "ol": ("object.v.cam", "mano.v3d.cam.l")}
    for k in ref:
        if k.startswith("dist."):
            _close(k, ours[k] ** 2, np.asarray(ref[k]) ** 2, atol=5e-7)
        elif k.startswith("idx."):
            src, dst = (ours[n].double().numpy() for n in pairs[k[4:]])
            picks = ours[k].numpy(), np.asarray(ref[k])
            d2 = [((src - np.take_along_axis(dst, i[..., None], 1)) ** 2).sum(-1) for i in picks]
            assert (picks[0] != picks[1]).mean() < 0.01, k
            np.testing.assert_allclose(d2[0], d2[1], atol=5e-7, err_msg=k)
        elif k in ours:
            _close(k, ours[k], ref[k], atol=1e-5)
    new = set(ref) - set(world["batch"])
    assert new <= set(ours), sorted(new - set(ours))


def _jax_eval(world):
    """The body of the JAX package's `make_eval_step`, jitted once, with its
    intermediates returned too."""
    mano_r, mano_l, bank = world["jax"]
    model = world["jax_model"]

    @jax.jit
    def run(variables, batch):
        targets = jprocess(batch, mano_r, mano_l, bank)
        out = model.apply(variables, batch["images"], train=False)
        last = {k: v[-1] for k, v in out["stacked"].items()}
        sel = jselect(last)
        pred = jdecode(sel, targets, mano_r, mano_l, bank)
        return last, sel, pred, jmeasure(pred, targets, jengine.BATCH_METRICS)

    return run(world["variables"], {k: jnp.asarray(v) for k, v in world["batch"].items()})


def test_select_decode_and_eval_step_match_jax(world):
    batch, port = world["batch"], world["port"]
    jlast, jsel, jpred, jrows = _jax_eval(world)
    with torch.no_grad():
        out = port(torch.from_numpy(batch["images"]))
    last = {k: v[-1] for k, v in out["stacked"].items()}
    for k in jlast:
        _close(f"stacked/{k}", last[k], jlast[k], atol=1e-4, rtol=1e-4)

    # the selection must not hinge on near ties
    prob = np.asarray(jax.nn.sigmoid(jlast["pred_logits"]))
    for c in (12, 13):
        top2 = np.sort(prob[:, :, c], 1)[:, -2:]
        assert np.min(top2[:, 1] - top2[:, 0]) > 1e-5

    sel = select_queries(last)
    for k in jsel:
        _close(f"select/{k}", sel[k], jsel[k], atol=1e-4, rtol=1e-4)

    targets = process_targets(engine.to_device(batch, "cpu"), *world["torch"])
    pred = decode_predictions(sel, targets, *world["torch"])
    for k in jpred:
        _close(f"decode/{k}", pred[k], jpred[k], atol=1e-4, rtol=1e-4)

    rows = engine.make_eval_step(port, *world["torch"], device="cpu")(batch)
    assert set(rows) == set(jrows)
    for k in jrows:
        assert rows[k].shape == (4,)
        np.testing.assert_array_equal(np.isnan(rows[k].numpy()), np.isnan(np.asarray(jrows[k])))
        _close(f"metric/{k}", rows[k], jrows[k], atol=1e-2, rtol=1e-4)


def test_evaluate_averages_rows_over_frames(world):
    step = engine.make_eval_step(world["port"], *world["torch"], device="cpu")
    rows = step(world["batch"])
    res = engine.evaluate(step, [world["batch"]] * 2)
    assert set(res) == {"aae", "mpjpe/ra/h", "mrrpe/r/l", "mrrpe/r/o",
                        "success_rate/0.05", "cdev/ho"}
    for k in ("aae", "mpjpe/ra/h", "mrrpe/r/l", "mrrpe/r/o", "success_rate/0.05"):
        assert np.isfinite(res[k]), k
        np.testing.assert_allclose(res[k], np.nanmean(rows[k].numpy()), rtol=1e-6)
