"""The port's export routes against the JAX package's, on the CPU: `xdict`,
the ARCTIC submission export (`cli/extract_predicts.py`), the feature
extraction (`cli/extract_features.py`) and a `local_fm` model fed from the
stored maps.

One tiny JAX model (1+1 layers, d = 64, 224x224, two-stage with box
refinement) is initialized once; its weights go into the port through
`state_dict_from_jax`. Tolerances: `extract_batch` on the same outputs
1e-5; the exported values before the float16 cast within 1e-4 of each
tensor's max, and every stored float16 tensor within one float16 ulp of the
JAX package's file; the backbone maps within 1e-4 of each map's max; the
`local_fm` model's outputs within 1e-4 (the JAX suite's model tolerance)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uvhand_tpu.cli.extract_predicts as jextract
from uvhand_tpu.cli.extract_features import extract_features as jextract_features
from uvhand_tpu.cli.extract_features import load_feature_maps as jload_feature_maps
from uvhand_tpu.data import arctic as jarctic
from uvhand_tpu.models.detr import UVHandDETR as JaxDETR
from uvhand_tpu.utils.xdict import xdict as jxdict
from uvhand_tpu_torch.cli import extract_predicts
from uvhand_tpu_torch.cli.extract_features import extract_features, load_feature_maps
from uvhand_tpu_torch.cli.main import get_args_parser, main
from uvhand_tpu_torch.data import arctic
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.train.convert import state_dict_from_jax
from uvhand_tpu_torch.utils.xdict import xdict

from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(num_queries=8, num_encoder_layers=1, num_decoder_layers=1, d_model=64, n_heads=4,
           dim_feedforward=128)


def _port(variables, **kw):
    model = UVHandDETR(**CFG, **kw, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    return model.eval()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    data = tmp_path_factory.mktemp("data")
    root = str(data / "arctic")
    arctic.make_synthetic_root(root, num_seqs=1, frames=3, views=2, seed=0)
    jmodel = JaxDETR(**CFG, dropout=0.0, feature_mask_ratio=0.0)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    return {"data": str(data), "root": root, "jmodel": jmodel, "variables": variables,
            "port": _port(variables)}


def test_xdict_as_jax():
    d = {"a.x": np.ones(3, np.float32), "a.y": np.zeros(3, np.float32), "b": 2.0, "n": "s"}
    ours, ref = xdict({k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                       for k, v in d.items()}), jxdict(d)
    for op in (lambda x: x.search("a."), lambda x: x.search("a.", replace_to=""),
               lambda x: x.prefix("pred."), lambda x: x.postfix(".r"), lambda x: x.rm("a.x"),
               lambda x: x.rm("a.", keep_list=["a.y"]), lambda x: x.subset(["b", "z"]),
               lambda x: x.mul(2.0)):
        a, b = op(ours).to_np(), op(ref).to_np()
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    t = xdict({"t": torch.ones(2, requires_grad=True)})
    assert not t.detach()["t"].requires_grad and t.to("cpu")["t"].device.type == "cpu"
    assert xdict({"c": 1}).merge(xdict({"e": 2})) == {"c": 1, "e": 2}
    with pytest.raises(AssertionError):
        xdict({"c": 1}).merge({"c": 2})


def test_extract_batch_and_std_interface_as_jax():
    rng = np.random.default_rng(3)
    L, B, Q = 2, 6, 8
    shapes = {"pred_logits": 14, "pred_hand_cam": 3, "pred_obj_cam": 3, "pred_mano_pose": 48,
              "pred_mano_beta": 10, "pred_obj_rot": 3, "pred_obj_rad": 1}
    stacked = {k: rng.normal(size=(L, B, Q, n)).astype(np.float32) for k, n in shapes.items()}
    stacked["pred_hand_cam"][..., 0] = np.abs(stacked["pred_hand_cam"][..., 0]) + 0.2
    K = np.tile(np.array([[1000.0, 0, 112], [0, 980.0, 112], [0, 0, 1]], np.float32), (B, 1, 1))
    names = [f"./arctic_data/data/images/s05/box_use_01/{1 + i % 2}/{i:05d}.jpg"
             for i in range(B)][::-1]
    ours = extract_predicts.extract_batch(
        {"stacked": {k: torch.from_numpy(v) for k, v in stacked.items()}},
        torch.from_numpy(K), names)
    ref = jextract.extract_batch({"stacked": {k: jnp.asarray(v) for k, v in stacked.items()}},
                                 jnp.asarray(K), names)
    assert sorted(ours) == sorted(ref) == sorted(extract_predicts.SUBMIT_KEYS)
    for k, v in ref.items():
        if isinstance(v, list):
            assert ours[k] == v
        else:
            assert ours[k].dtype == np.float32
            np.testing.assert_allclose(ours[k], v, atol=1e-5, rtol=0, err_msg=k)
    a, b = extract_predicts.std_interface([ours]), jextract.std_interface([ref])
    assert sorted(a) == sorted(b) == ["s05_box_use_01_1", "s05_box_use_01_2"]
    for cam in a:
        assert a[cam]["meta_info.imgname"] == b[cam]["meta_info.imgname"]
        assert a[cam]["meta_info.imgname"] == sorted(a[cam]["meta_info.imgname"])


def _tree(path):
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, files in os.walk(path) for f in files)


def _within_one_ulp(ours: torch.Tensor, ref: torch.Tensor, name):
    a, b = ours.numpy(), ref.numpy()
    assert a.dtype == b.dtype == np.float16, name
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    assert (np.abs(a.astype(np.float32) - b.astype(np.float32)) <= ulp).all(), name


def test_run_extraction_writes_the_jax_packages_files(setup, tmp_path, monkeypatch):
    kw = dict(setup="p1", split="val")
    ds, jds = arctic.ArcticDataset(setup["root"], **kw), jarctic.ArcticDataset(setup["root"], **kw)
    ref_values = {}
    save = jextract.save_results

    def keep(out_cam, out_dir):
        ref_values.update(out_cam)
        save(out_cam, out_dir)

    monkeypatch.setattr(jextract, "save_results", keep)
    jextract.run_extraction(setup["jmodel"], setup["variables"], jds, 2, str(tmp_path / "ref"))
    values, timing = {}, {}
    out = extract_predicts.run_extraction(setup["port"], ds, 2, str(tmp_path / "ours"),
                                          results=values, timing=timing)
    assert out == str(tmp_path / "ours") and len(timing["batch_ms"]) == -(-len(ds) // 2)
    assert _tree(tmp_path / "ours") == _tree(tmp_path / "ref")
    assert len(_tree(tmp_path / "ours")) == 2 * 10  # two cameras, 9 preds + imgname
    assert sorted(values) == sorted(ref_values)
    for cam, cur in ref_values.items():
        for k, v in cur.items():
            if isinstance(v, list):
                assert values[cam][k] == v
                continue
            tol = 1e-4 * max(1.0, float(np.abs(v).max()))
            np.testing.assert_allclose(values[cam][k], v, atol=tol, rtol=0, err_msg=k)
    for name in _tree(tmp_path / "ref"):
        a = torch.load(tmp_path / "ours" / name, weights_only=False)
        b = torch.load(tmp_path / "ref" / name, weights_only=False)
        if isinstance(b, list):
            assert a == b, name
        else:
            assert a.shape == b.shape, name
            _within_one_ulp(a, b, name)


def test_extract_features_and_a_local_fm_model_as_jax(setup, tmp_path):
    kw = dict(setup="p1", split="val")
    ds, jds = arctic.ArcticDataset(setup["root"], **kw), jarctic.ArcticDataset(setup["root"], **kw)
    ours = extract_features(setup["port"], ds, str(tmp_path / "ours"), split="val", batch_size=4)
    ref = jextract_features(setup["jmodel"], setup["variables"], jds, str(tmp_path / "ref"),
                            split="val", batch_size=4)
    assert os.path.relpath(ours, tmp_path / "ours") == os.path.relpath(ref, tmp_path / "ref")
    assert _tree(tmp_path / "ours") == _tree(tmp_path / "ref")
    names = ds.imgnames[:2]
    maps = load_feature_maps(str(tmp_path / "ours"), names, split="val")
    jmaps = jload_feature_maps(str(tmp_path / "ref"), names, split="val")
    assert [m.shape for m in maps] == [(2, 28, 28, 512), (2, 14, 14, 1024), (2, 7, 7, 2048)]
    for m, jm in zip(maps, jmaps):
        assert m.dtype == np.float32
        np.testing.assert_allclose(m, jm, atol=1e-4 * float(np.abs(jm).max()), rtol=0)

    fm_cfg = dict(feature_type="local_fm", num_feature_levels=3)
    jfm = JaxDETR(**CFG, **fm_cfg, dropout=0.0, feature_mask_ratio=0.0)
    fm = [jnp.asarray(m) for m in jmaps]
    ref_out, variables = jax.jit(jfm.init_with_output)(jax.random.PRNGKey(1), fm)
    assert "backbone" not in variables["params"]
    port = _port(variables, **fm_cfg)
    assert not any(k.startswith("backbone.") for k in port.state_dict())
    with torch.inference_mode():
        out = port([torch.from_numpy(m) for m in jmaps])
    for k in ("pred_logits", "pred_hand_key", "pred_mano_pose", "pred_obj_cam"):
        np.testing.assert_allclose(out["stacked"][k].numpy(), np.asarray(ref_out["stacked"][k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    with pytest.raises(ValueError, match="num_feature_levels must be 3"):
        UVHandDETR(**CFG, feature_type="local_fm", device="cpu")


def test_the_clis_export_routes_write_what_the_functions_write(setup, tmp_path):
    """`--extraction_mode` and `--extract` through the CLI (the seeded model
    it builds) write the files `run_extraction` / `extract_features` write
    for the same model."""
    common = ["--dataset_file", "arctic", "--coco_path", setup["data"], "--two_stage",
              "--with_box_refine", "--enc_layers", "1", "--dec_layers", "1", "--hidden_dim",
              "64", "--dim_feedforward", "128", "--nheads", "4", "--num_queries", "8",
              "--val_batch_size", "2", "--batch_size", "4", "--num_workers", "2", "--device",
              "cpu"]
    res = main(get_args_parser().parse_args(
        common + ["--output_dir", str(tmp_path / "cli"), "--extraction_mode", "submit_pose"]))
    sub = tmp_path / "cli" / "submission"
    n_val = len(arctic.ArcticDataset(setup["root"], "p1", "val"))
    assert res["submission"] == str(sub) and len(res["timing"]["batch_ms"]) == -(-n_val // 2)
    assert res["image_routes"]["val"] == {"python": n_val}
    res = main(get_args_parser().parse_args(
        common + ["--output_dir", str(tmp_path / "cli2"), "--extract"]))
    feats = os.path.join(setup["data"], "pickle", "p1_2048", "train")
    n_train = len(arctic.ArcticDataset(setup["root"], "p1", "train"))
    assert res["features"] == feats and len(_tree(feats)) == n_train

    from uvhand_tpu_torch.cli.main import build_model

    args = get_args_parser().parse_args(common)
    model = build_model(args, "cpu")
    ds = arctic.ArcticDataset(setup["root"], "p1", "val")
    extract_predicts.run_extraction(model, ds, 2, str(tmp_path / "api"))
    assert _tree(tmp_path / "api") == _tree(sub)
    for name in _tree(sub):
        a, b = torch.load(sub / name, weights_only=False), torch.load(
            tmp_path / "api" / name, weights_only=False)
        assert a == b if isinstance(a, list) else torch.equal(a, b), name
