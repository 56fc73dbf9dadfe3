"""The port's sequence metrics and the rest of its eval path against the JAX
package's, on the CPU.

  - `arctic_smoothing`, `compute_error_accel`, `eval_acc_pose` and
    `eval_motion_deviation` on seeded arrays (the MDev arrays hold contact
    windows, one at each border and one too short among them), 1e-5;
  - `make_eval_step(metrics=subset, smooth_iter=1)` and `evaluate_sequences`
    on a synthetic ARCTIC root whose object GT is consistent with the bank,
    with the port's weights carried to the JAX tree by
    `convert_reference_detr`. Metric rows and scores 1e-2 mm + 1e-4
    relative, as `tests/test_torch_eval.py` holds them: the metrics take
    differences of camera-space points ~0.6 m from the camera and scale
    them by 1000.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from uvhand_tpu import engine as jengine
from uvhand_tpu.data import arctic as jarctic
from uvhand_tpu.evaluation import mdev as jmdev
from uvhand_tpu.evaluation import metrics as jmetrics
from uvhand_tpu.geometry import mano as jmano
from uvhand_tpu.geometry import objects as jobjects
from uvhand_tpu.models.detr import UVHandDETR as JaxDETR
from uvhand_tpu.train.convert import convert_reference_detr
from uvhand_tpu.utils.tools import arctic_smoothing as jsmoothing
from uvhand_tpu_torch import engine
from uvhand_tpu_torch.data import arctic
from uvhand_tpu_torch.evaluation import mdev, metrics
from uvhand_tpu_torch.geometry import mano, objects
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.utils.tools import arctic_smoothing

from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(num_queries=12, num_encoder_layers=1, num_decoder_layers=2, d_model=64,
           n_heads=4, dim_feedforward=128)
SUBSET = ("aae", "mpjpe.ra", "cdev", "mdev")  # mdev: a sequence metric, filtered out


def close(name, ours, ref, atol, rtol=0.0):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref), err_msg=name)
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("count", [1, 3])
@pytest.mark.parametrize("T", [2, 7, 50])
def test_arctic_smoothing_matches_jax(T, count):
    x = np.random.default_rng(T + count).normal(size=(3, T, 5)).astype(np.float32)
    close("smoothing", arctic_smoothing(torch.from_numpy(x), count),
          jsmoothing(jnp.asarray(x), count), atol=1e-5)


def sequence(rng, F=9, V=40, J=21):
    """Time-ordered camera-space predictions and targets of one sequence,
    with some invalid frames and hands."""
    mk = lambda *s: rng.normal(scale=0.05, size=s).astype(np.float32) + np.float32(0.6)
    tgt = {"mano.v3d.cam.r": mk(F, V, 3), "mano.v3d.cam.l": mk(F, V, 3),
           "mano.j3d.cam.r": mk(F, J, 3), "mano.j3d.cam.l": mk(F, J, 3),
           "object.v.cam": mk(F, V, 3),
           "object.parts_ids": rng.integers(1, 3, size=(F, V)).astype(np.int32),
           "is_valid": (rng.uniform(size=F) > 0.15).astype(np.float32),
           "left_valid": (rng.uniform(size=F) > 0.2).astype(np.float32),
           "right_valid": np.ones(F, np.float32)}
    pred = {k: tgt[k] + rng.normal(scale=0.01, size=tgt[k].shape).astype(np.float32)
            for k in ("mano.v3d.cam.r", "mano.v3d.cam.l", "mano.j3d.cam.r", "mano.j3d.cam.l",
                      "object.v.cam")}
    return pred, tgt


def test_compute_error_accel_matches_jax():
    rng = np.random.default_rng(0)
    gt, pred = (rng.normal(size=(8, 30, 3)).astype(np.float32) for _ in range(2))
    for fps in (30.0, 15.0):
        close("accel", metrics.compute_error_accel(torch.from_numpy(gt), torch.from_numpy(pred),
                                                   fps),
              jmetrics.compute_error_accel(jnp.asarray(gt), jnp.asarray(pred), fps),
              atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_acc_pose_matches_jax(seed):
    pred, tgt = sequence(np.random.default_rng(seed))
    ours = metrics.eval_acc_pose({k: torch.from_numpy(v) for k, v in pred.items()},
                                 {k: torch.from_numpy(v) for k, v in tgt.items()})
    ref = jmetrics.eval_acc_pose({k: jnp.asarray(v) for k, v in pred.items()},
                                 {k: jnp.asarray(v) for k, v in tgt.items()})
    assert set(ours) == set(ref) == {"acc/h", "acc/o"}
    for k in ref:
        assert ours[k].shape == (9,) and np.isnan(ours[k][[0, -1]].numpy()).all()
        close(k, ours[k], ref[k], atol=1e-5, rtol=1e-5)


def contact_sequence(rng, F=40, V=60, O=50):
    """Predictions and targets with contact windows: hand vertex 3 touches
    object vertex 7 over frames 4..22 (a window), vertex 10 over 0..17
    (touches the start: skipped), vertex 20 over 25..32 (too short), and
    vertex 30 over 24..39 (touches the end)."""
    dist = rng.uniform(0.01, 0.05, size=(F, V)).astype(np.float32)
    idx = rng.integers(0, O, size=(F, V)).astype(np.int32)
    for v, (s, e) in ((3, (4, 22)), (10, (0, 17)), (20, (25, 32)), (30, (24, 39))):
        dist[s:e + 1, v] = 1e-3
        idx[s:e + 1, v] = 7
    vo = rng.normal(scale=0.05, size=(F, O, 3)).astype(np.float32)
    tgt = {"dist.ro": dist, "idx.ro": idx, "dist.lo": dist[:, ::-1].copy(),
           "idx.lo": idx[:, ::-1].copy(), "object.v.cam": vo,
           "is_valid": (rng.uniform(size=F) > 0.1).astype(np.float32),
           "left_valid": np.ones(F, np.float32), "right_valid": np.ones(F, np.float32)}
    pred = {"mano.v3d.cam.r": rng.normal(size=(F, V, 3)).astype(np.float32),
            "mano.v3d.cam.l": rng.normal(size=(F, V, 3)).astype(np.float32),
            "object.v.cam": rng.normal(size=(F, O, 3)).astype(np.float32)}
    return pred, tgt


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_motion_deviation_matches_jax(seed):
    pred, tgt = contact_sequence(np.random.default_rng(seed))
    wins = mdev.find_windows(tgt["dist.ro"], tgt["idx.ro"], tgt["object.v.cam"][0])
    assert wins == jmdev.find_windows(tgt["dist.ro"], tgt["idx.ro"], tgt["object.v.cam"][0])
    assert [w[2] for w in wins] == [3] and wins[0][:2] == [4, 22]
    ours = mdev.eval_motion_deviation(pred, tgt)["mdev/h"]
    ref = jmdev.eval_motion_deviation(pred, tgt)["mdev/h"]
    assert len(ours) == 2 and np.isfinite(ours).all()
    close("mdev/h", ours, ref, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A root of 1 sequence x 5 frames x 2 views, the port's model with
    random sampling weights (the decoder's picks then hinge on no tie), its
    weights converted for the JAX model, and both packages' MANO and bank."""
    root = str(tmp_path_factory.mktemp("arctic"))
    jbank = jobjects.synthetic_object_bank(2)
    jarctic.make_synthetic_root(root, num_seqs=1, frames=5, views=2, obj_bank=jbank)
    ds = arctic.ArcticDataset(root, "p1", "val", kp3d_cano=np.asarray(jbank.kp_bottom))
    port = UVHandDETR(**CFG, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    sd = port.state_dict()
    for k, v in sd.items():
        if k.endswith(("sampling_offsets.weight", "attention_weights.weight")):
            v.copy_(torch.from_numpy(rng.normal(scale=0.05, size=v.shape).astype(np.float32)))
    return {
        "ds": ds, "port": port,
        "jds": jarctic.ArcticDataset(root, "p1", "val", kp3d_cano=np.asarray(jbank.kp_bottom)),
        "jax_model": JaxDETR(**CFG, dropout=0.0, feature_mask_ratio=0.0),
        "variables": convert_reference_detr(sd, num_decoder_layers=2, num_encoder_layers=1,
                                            n_heads=4),
        "jax": (jmano.synthetic_mano(0, True), jmano.synthetic_mano(1, False), jbank),
        "torch": (mano.synthetic_mano(0, True, device="cpu"),
                  mano.synthetic_mano(1, False, device="cpu"),
                  objects.synthetic_object_bank(2, device="cpu")),
    }


def test_eval_step_with_a_metric_subset_and_smoothing_matches_jax(world):
    batch = arctic.collate([world["ds"][i] for i in range(4)])
    step = engine.make_eval_step(world["port"], *world["torch"], metrics=SUBSET, smooth_iter=1,
                                 device="cpu")
    rows = step(batch)
    jstep = jengine.make_eval_step(world["jax_model"], *world["jax"], metrics=SUBSET,
                                   smooth_iter=1)
    jrows = jstep(world["variables"]["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    assert set(rows) == set(jrows) == {"aae", "mpjpe/ra/h", "cdev/ho"}
    for k in jrows:
        close(f"metric/{k}", rows[k], jrows[k], atol=1e-2, rtol=1e-4)
    plain = engine.make_eval_step(world["port"], *world["torch"], metrics=SUBSET,
                                  device="cpu")(batch)
    assert not np.allclose(plain["cdev/ho"].numpy(), rows["cdev/ho"].numpy(), equal_nan=True)


def test_evaluate_sequences_matches_jax(world):
    step = engine.make_sequence_eval_step(world["port"], *world["torch"], device="cpu")
    jstep = jengine.make_sequence_eval_step(world["jax_model"], *world["jax"])
    for batch_size, max_frames in ((4, None), (3, 4)):
        ours = engine.evaluate_sequences(step, world["ds"], batch_size, max_frames=max_frames)
        ref = jengine.evaluate_sequences(world["variables"]["params"], jstep, world["jds"],
                                         batch_size, max_frames=max_frames)
        assert set(ours) == set(ref) == {"acc/h", "acc/o", "mdev/h"}
        assert np.isfinite(ours["acc/h"]) and np.isfinite(ours["acc/o"])
        for k in ref:
            close(f"{k} ({batch_size}, {max_frames})", np.float64(ours[k]), np.float64(ref[k]),
                  atol=1e-2, rtol=1e-4)
