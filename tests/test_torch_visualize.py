"""The port's visualization (`evaluation/visualize.py`) against the JAX
package's, on the CPU.

The numpy/cv2 drawing and rasterizing functions are copies: they give the
JAX package's arrays bit for bit, and the OBJ files are byte for byte the
same. `save_eval_visualizations` runs the port's serving step on the device
of the model (here the CPU) and the JAX package's jitted one, with one tiny
JAX model's weights (1+1 layers, d = 64, 224x224) carried into the port by
`state_dict_from_jax`:
  - the projected keypoints agree within 1e-3 px (the camera-space
    predictions through f ~ 1000 px; float32 rounding of the model, the
    decode and the FK gives up to 6.3e-4 px here, so 1e-4 px fails);
  - the same files are written; the OBJ vertices (6 decimals) agree within
    1e-5 m + 1e-5 of their value (the random model puts hands up to ~14 m
    out, and its outputs agree to ~1e-5 relative);
  - at most 0.5 % of a PNG's pixels may differ (a keypoint whose pixel
    coordinate sits within 1e-3 px of an integer is drawn one pixel over);
    0 differ here.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uvhand_tpu.evaluation.visualize as jvis
from uvhand_tpu.data import arctic as jarctic
from uvhand_tpu.geometry import mano as jmano
from uvhand_tpu.geometry import objects as jobjects
from uvhand_tpu.models.detr import UVHandDETR as JaxDETR
from uvhand_tpu_torch.data import arctic
from uvhand_tpu_torch.evaluation import visualize as vis
from uvhand_tpu_torch.geometry import mano, objects
from uvhand_tpu_torch.models.detr import UVHandDETR
from uvhand_tpu_torch.train.convert import state_dict_from_jax

from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(num_queries=8, num_encoder_layers=1, num_decoder_layers=1, d_model=64, n_heads=4,
           dim_feedforward=128)


def _img(rng):
    return rng.normal(size=(224, 224, 3)).astype(np.float32)


def test_drawing_and_raster_functions_are_the_jax_packages(tmp_path):
    rng = np.random.default_rng(5)
    img = _img(rng)
    np.testing.assert_array_equal(vis.denormalize_image(img), jvis.denormalize_image(img))
    kp = {"r": rng.uniform(-1, 1, (21, 2)), "l": rng.uniform(-1, 1, (21, 2)),
          "o": rng.uniform(-1, 1, (32, 2)), "x": rng.uniform(-1.2, 1.2, (16, 2))}
    np.testing.assert_array_equal(vis.draw_keypoints_2d(img, kp), jvis.draw_keypoints_2d(img, kp))

    verts = (rng.normal(size=(60, 3)) * 0.05 + [0, 0, 0.6]).astype(np.float32)
    faces = rng.integers(0, 60, size=(90, 3))
    K = np.array([[600.0, 0, 112], [0, 600.0, 112], [0, 0, 1]], np.float32)
    px = verts[:, :2] / verts[:, 2:] * 600.0 + 112.0
    bufs = []
    for f in (vis.rasterize_mesh, jvis.rasterize_mesh):
        zbuf, shaded = np.full((224, 224), np.inf, np.float32), np.zeros((224, 224, 3),
                                                                        np.float32)
        f(zbuf, shaded, px, verts[:, 2], faces, (200, 100, 50))
        bufs.append((zbuf, shaded))
    assert np.isfinite(bufs[0][0]).sum() > 100
    for a, b in zip(*bufs):
        np.testing.assert_array_equal(a, b)
    meshes = [(verts, faces, (255, 0, 0)), (verts * [1, 1, 1.1], faces, (0, 255, 0)),
              (verts, None, (0, 0, 255))]
    np.testing.assert_array_equal(vis.render_mesh_overlay(img, meshes, K),
                                  jvis.render_mesh_overlay(img, meshes, K))

    pred = {"mano.v3d.cam.r": rng.normal(size=(2, 778, 3)),
            "mano.v3d.cam.l": rng.normal(size=(2, 778, 3)),
            "object.v.cam": rng.normal(size=(2, 40, 3)), "object.v_len": np.array([30, 40])}
    hand_f = rng.integers(0, 778, size=(20, 3))
    for module, d in ((vis, "ours"), (jvis, "ref")):
        module.export_scene(str(tmp_path / d), 1, pred, hand_f, hand_f[::-1], faces)
        module.export_obj(str(tmp_path / d / "plain.obj"), verts)
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "ours")) and len(names) == 4
    for n in names:
        assert (tmp_path / "ours" / n).read_bytes() == (tmp_path / "ref" / n).read_bytes(), n


def test_save_eval_visualizations_as_jax(tmp_path, monkeypatch):
    import cv2

    jbank = jobjects.synthetic_object_bank(2)
    root = str(tmp_path / "arctic")
    arctic.make_synthetic_root(root, num_seqs=1, frames=3, views=2, seed=0,
                               obj_bank=objects.synthetic_object_bank(2, device="cpu"))
    kp3d = np.asarray(jbank.kp_bottom)
    ds = arctic.ArcticDataset(root, "p1", "val", kp3d_cano=kp3d)
    jds = jarctic.ArcticDataset(root, "p1", "val", kp3d_cano=kp3d)
    jmodel = JaxDETR(**CFG, dropout=0.0, feature_mask_ratio=0.0)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    port = UVHandDETR(**CFG, generator=torch.Generator().manual_seed(0), device="cpu")
    port.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    world = (mano.synthetic_mano(0, True, device="cpu"),
             mano.synthetic_mano(1, False, device="cpu"),
             objects.synthetic_object_bank(2, device="cpu"))
    jworld = (jmano.synthetic_mano(0, True), jmano.synthetic_mano(1, False), jbank)

    drawn = {"ours": [], "ref": []}
    for module, key in ((vis, "ours"), (jvis, "ref")):
        draw = module.draw_keypoints_2d

        def record(img, kp2d, img_res=224, _draw=draw, _key=key):
            drawn[_key].append({k: np.asarray(v) for k, v in kp2d.items()})
            return _draw(img, kp2d, img_res)

        monkeypatch.setattr(module, "draw_keypoints_2d", record)
    out = vis.save_eval_visualizations(port, ds, *world, str(tmp_path / "ours"), max_frames=6)
    jvis.save_eval_visualizations(jmodel, variables["params"], jds, *jworld,
                                  str(tmp_path / "ref"), max_frames=6)
    assert out == str(tmp_path / "ours")
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "ours"))
    pngs = [n for n in names if n.endswith(".png")]
    assert len(pngs) == min(6, len(ds)) and sum(n.endswith(".obj") for n in names) == 12

    assert len(drawn["ours"]) == len(drawn["ref"]) == len(pngs)
    worst = 0.0
    for a, b in zip(drawn["ours"], drawn["ref"]):
        for k in b:  # normalized coordinates -> crop pixels
            np.testing.assert_allclose(112.0 * (a[k] + 1), 112.0 * (b[k] + 1), atol=1e-3,
                                       rtol=0, err_msg=k)
            worst = max(worst, float(np.abs(112.0 * (a[k] - b[k])).max()))
    print(f"largest keypoint difference: {worst:.3e} px")
    for n in pngs:
        a = cv2.imread(str(tmp_path / "ours" / n))
        b = cv2.imread(str(tmp_path / "ref" / n))
        differ = int((a != b).any(-1).sum())
        print(f"{n}: {differ} pixels differ")
        assert differ <= 0.005 * 224 * 224, (n, differ)
    for n in names:
        if n.endswith(".obj"):
            ours = np.loadtxt([ln[2:] for ln in open(tmp_path / "ours" / n) if ln[:2] == "v "])
            ref = np.loadtxt([ln[2:] for ln in open(tmp_path / "ref" / n) if ln[:2] == "v "])
            np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5, err_msg=n)
            assert [ln for ln in open(tmp_path / "ours" / n) if ln[:2] == "f "] == \
                [ln for ln in open(tmp_path / "ref" / n) if ln[:2] == "f "]
