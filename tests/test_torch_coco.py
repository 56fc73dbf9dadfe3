"""The port's COCO-format route (AssemblyHands / H2O / FPHA) on the CPU.

  - `make_synthetic_coco_root` writes the JAX package's files byte for
    byte, and `CocoHandsDataset` reads them into the JAX dataset's samples
    bit for bit: without augmentation, with it (the colour jitter and the
    rotation drawn from the same seeded generator in the same order, over
    several samples) and with `cache_mode` (the second read from the cache);
    `collate` stacks them as the JAX CLI's collate does;
  - `coco_eval` (`box_iou`, `average_precision`, `evaluate_detections`,
    `assembly_keypoint_metrics`) equals the JAX functions on random data;
  - the eval step's per-slot selection (`engine.make_assembly_eval_step`)
    equals the JAX CLI's `run_coco` eval expression on the same logits and
    keypoints, ties included;
  - the CLI, `--device cpu`, `--dataset_file AssemblyHands`, `H2O` and
    `FPHA` (and `H2O --cache_mode`): one `--debug` step of a 1+2-layer d=64
    `AssemblyDETR` at 128x128, a checkpoint in `out/0`, results and losses
    written, every number finite; `--eval --resume out/0` gives the scores
    of the eval that closed the epoch, exactly.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvhand_tpu.data import coco_hands as jcoco
from uvhand_tpu.evaluation import coco_eval as jeval
from uvhand_tpu_torch import engine
from uvhand_tpu_torch.cli.main import get_args_parser, main
from uvhand_tpu_torch.data import coco_hands
from uvhand_tpu_torch.evaluation import coco_eval

from test_torch_train import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("coco")
    ours, ref = str(base / "ours"), str(base / "ref")
    coco_hands.make_synthetic_coco_root(ours, n_images=5, seed=3, image_hw=(120, 160))
    jcoco.make_synthetic_coco_root(ref, n_images=5, seed=3, image_hw=(120, 160))
    return ours, ref


def test_synthetic_roots_are_the_same_files(roots):
    ours, ref = roots
    for sub, names in (("annotations", ("train.json", "val.json")),
                       ("images", sorted(os.listdir(os.path.join(ref, "images"))))):
        assert sorted(os.listdir(os.path.join(ours, sub))) == sorted(names)
        for name in names:
            assert filecmp.cmp(os.path.join(ours, sub, name), os.path.join(ref, sub, name),
                               shallow=False), name


@pytest.mark.parametrize("mode", ["plain", "augmented", "cache_mode"])
def test_dataset_samples_equal_jax_bit_for_bit(roots, mode):
    root = roots[0]
    kw = dict(img_res=96, aug=mode == "augmented", seed=5, cache_mode=mode == "cache_mode")
    ours, ref = coco_hands.CocoHandsDataset(root, "train", **kw), jcoco.CocoHandsDataset(
        root, "train", **kw)
    assert len(ours) == len(ref) == 5
    order = [0, 3, 1, 3, 4, 0] if mode != "plain" else range(5)
    for i in order:
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b) == ["images", "keypoints63", "labels", "target_valid"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{mode} {i} {k}")
    if mode == "cache_mode":
        assert sorted(ours._img_cache) == [0, 1, 3, 4]
        np.testing.assert_array_equal(ours[0]["images"], coco_hands.CocoHandsDataset(
            root, "train", img_res=96)[0]["images"])
    batch = coco_hands.collate([ours[0], ours[1]])
    assert batch["images"].shape == (2, 96, 96, 3) and batch["labels"].shape == (2, 3)


def test_coco_eval_equals_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 50, (7, 2))
    a = np.concatenate([xy, xy + rng.uniform(1, 30, (7, 2))], 1)
    xy = rng.uniform(0, 50, (5, 2))
    b = np.concatenate([xy, xy + rng.uniform(1, 30, (5, 2))], 1)
    np.testing.assert_array_equal(coco_eval.box_iou(a, b), jeval.box_iou(a, b))
    scores, matched = rng.uniform(size=20), rng.uniform(size=20) < 0.5
    assert coco_eval.average_precision(scores, matched, 12) == jeval.average_precision(
        scores, matched, 12)
    assert np.isnan(coco_eval.average_precision(scores, matched, 0))
    preds, gts = [], []
    for _ in range(4):
        n, m = int(rng.integers(1, 6)), int(rng.integers(1, 4))
        xy = rng.uniform(0, 40, (m, 2))
        gb = np.concatenate([xy, xy + rng.uniform(5, 20, (m, 2))], 1)
        pb = np.concatenate([gb + rng.normal(scale=2.0, size=gb.shape),
                             rng.uniform(0, 60, (n, 4))])
        preds.append({"boxes": pb, "scores": rng.uniform(size=len(pb)),
                      "labels": rng.integers(1, 3, len(pb))})
        gts.append({"boxes": gb, "labels": rng.integers(1, 3, m)})
    assert coco_eval.evaluate_detections(preds, gts) == jeval.evaluate_detections(preds, gts)
    pred, gt = rng.uniform(size=(6, 3, 63)), rng.uniform(size=(6, 3, 63))
    valid = rng.uniform(size=(6, 3)) < 0.7
    assert coco_eval.assembly_keypoint_metrics(pred, gt, valid, (224, 224)) == \
        jeval.assembly_keypoint_metrics(pred, gt, valid, (224, 224))


def test_eval_selection_equals_the_jax_clis():
    """The JAX CLI's `run_coco` eval step, on the model's last-layer outputs:
    per GT slot the query most probable for the slot's label (-1 read as
    0), the first such query on a tie."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 3, 12)).astype(np.float32)
    logits[0, :, 9] = 2.0  # a tie: the first query wins
    keys = rng.uniform(size=(4, 3, 63)).astype(np.float32)
    labels = np.array([[9, 10, 3], [9, -1, 5], [10, 9, 1], [-1, -1, 8]], np.int32)

    lab = jnp.maximum(jnp.asarray(labels), 0)
    per_slot = jnp.take_along_axis(jax.nn.sigmoid(jnp.asarray(logits)).transpose(0, 2, 1),
                                   lab[:, :, None], axis=1)
    q = jnp.argmax(per_slot, -1)
    ref = jnp.take_along_axis(jnp.asarray(keys), q[..., None], axis=1)

    class Fixed(torch.nn.Module):
        def forward(self, images):
            return {"stacked": {"pred_logits": torch.from_numpy(logits)[None],
                                "pred_keypoints": torch.from_numpy(keys)[None]}}

    step = engine.make_assembly_eval_step(Fixed(), device="cpu")
    out = step({"images": np.zeros((4, 8, 8, 3), np.float32), "labels": labels,
                "keypoints63": keys, "target_valid": labels >= 0})
    np.testing.assert_array_equal(out["pred"].numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out["pred"][0, 0].numpy(), keys[0, 0])


TINY = ["--device", "cpu", "--enc_layers", "1", "--dec_layers", "2", "--hidden_dim", "64",
        "--batch_size", "2", "--val_batch_size", "2", "--img_res", "128", "--num_workers", "2"]


@pytest.mark.parametrize("dataset,extra", [("AssemblyHands", []), ("H2O", []), ("FPHA", []),
                                           ("H2O", ["--cache_mode"])],
                         ids=["assembly", "h2o", "fpha", "h2o_cache_mode"])
def test_cli_trains_checkpoints_and_resumes_each_coco_dataset(tmp_path, dataset, extra):
    coco_hands.make_synthetic_coco_root(str(tmp_path / "data" / dataset), n_images=4, seed=2,
                                        image_hw=(96, 128))
    base = TINY + ["--dataset_file", dataset, "--coco_path", str(tmp_path / "data"), *extra]
    out = tmp_path / "out"
    res = main(get_args_parser().parse_args(
        base + ["--output_dir", str(out), "--epochs", "1", "--debug", "--num_debug", "1"]))
    (epoch,) = res["epochs"]
    assert epoch["epoch"] == 0 and len(res["timing"]["step_ms"]) == 1
    assert os.path.isfile(out / "0" / "checkpoint.pth")
    saved = torch.load(out / "0" / "checkpoint.pth", weights_only=False)
    assert saved["step"] == 1 and "cls_embed.2.bias" in saved["model"]
    assert all(np.isfinite(v) for v in {**epoch["stats"], **epoch["scores"]}.values())
    assert sorted(epoch["scores"]) == ["depth_mae", "mpjpe_uv_px"]
    with open(out / "results.txt") as f:
        assert json.loads(f.readline())["mpjpe_uv_px"] == epoch["scores"]["mpjpe_uv_px"]
    resumed = main(get_args_parser().parse_args(
        base + ["--output_dir", str(tmp_path / "eval"), "--eval", "--resume", str(out / "0")]))
    assert resumed["scores"] == [epoch["scores"]]
