"""The port's disk data path against the JAX package's, on the CPU.

One synthetic ARCTIC root (`make_synthetic_root`, written by each package
from one seed) is read by both packages' `ArcticDataset`; the port's
`collate`, `DataLoader` order and `device_prefetch` (on the CPU, a plain
conversion) are held against the JAX package's, and the port's
`load_object_bank` against the JAX loader on a two-object meta directory
the test writes. The data path is numpy and cv2 in both packages, with the
same random draws in the same order, so every comparison is exact
(`np.array_equal`, NaN-free data).
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from uvhand_tpu.data import arctic as jarctic
from uvhand_tpu.data import loader as jloader
from uvhand_tpu.geometry import objects as jobjects
from uvhand_tpu_torch.data import arctic, loader
from uvhand_tpu_torch.geometry import objects

from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

ROOT_KW = dict(num_seqs=2, frames=4, views=2, seed=3, image_hw=(120, 168))


def assert_same(a, b, where=""):
    """Nested dicts/lists of arrays and scalars, equal exactly."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        assert np.array_equal(a, b), where


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The port's and the JAX package's roots, each with the object GT
    posed from its own (equal) synthetic bank."""
    base = tmp_path_factory.mktemp("roots")
    port, jax_ = str(base / "port"), str(base / "jax")
    arctic.make_synthetic_root(port, obj_bank=objects.synthetic_object_bank(2, device="cpu"),
                               **ROOT_KW)
    jarctic.make_synthetic_root(jax_, obj_bank=jobjects.synthetic_object_bank(2), **ROOT_KW)
    return port, jax_


def files_of(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("bank", [False, True], ids=["random_object", "bank_object"])
def test_make_synthetic_root_writes_the_jax_packages_files(bank, tmp_path):
    kw = dict(ROOT_KW, frames=3)
    arctic.make_synthetic_root(str(tmp_path / "p"), **kw, obj_bank=(
        objects.synthetic_object_bank(2, device="cpu") if bank else None))
    jarctic.make_synthetic_root(str(tmp_path / "j"), **kw, obj_bank=(
        jobjects.synthetic_object_bank(2) if bank else None))
    port, jax_ = str(tmp_path / "p"), str(tmp_path / "j")
    assert files_of(port) == files_of(jax_)
    for name in files_of(port):
        a, b = os.path.join(port, name), os.path.join(jax_, name)
        if name.endswith(".npy"):
            assert_same(np.load(a, allow_pickle=True).item(),
                        np.load(b, allow_pickle=True).item(), name)
        elif name.endswith(".json"):
            assert json.load(open(a)) == json.load(open(b))
        else:
            assert np.array_equal(cv2.imread(a), cv2.imread(b)), name


#: dataset configurations: split and keyword arguments
CONFIGS = {
    "train_augmented": ("train", dict(seed=5)),
    "val": ("val", {}),
    "seq_filter": ("val", dict(seq="box_use_01")),
    "viewpoint_filter": ("val", dict(viewpoint="s01/capsulemachine_use_00/1")),
    "mini_split": ("minitrain", dict(seed=2)),
    "eval_mode": ("val", dict(eval_mode=True)),
    "no_cano": ("train", dict(seed=1, two_stage=False)),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_arctic_dataset_samples_equal_the_jax_packages(config, roots):
    port_root, jax_root = roots
    split, kw = CONFIGS[config]
    cano = None if config == "no_cano" else \
        objects.synthetic_object_bank(2, device="cpu").kp_bottom.numpy()
    ours = arctic.ArcticDataset(port_root, "p1", split, kp3d_cano=cano, **kw)
    ref = jarctic.ArcticDataset(jax_root, "p1", split, kp3d_cano=cano, **kw)
    assert ours.imgnames == ref.imgnames and len(ours) > 0
    assert ours.aug == ref.aug
    for i in range(len(ours)):
        assert_same(ours[i], ref[i], f"{config}[{i}]")


def test_collate_and_loader_order_equal_the_jax_packages(roots):
    port_root, jax_root = roots
    cano = objects.synthetic_object_bank(2, device="cpu").kp_bottom.numpy()
    ours = arctic.ArcticDataset(port_root, "p1", "train", seed=4, kp3d_cano=cano)
    ref = jarctic.ArcticDataset(jax_root, "p1", "train", seed=4, kp3d_cano=cano)
    assert_same(arctic.collate([ours[0], ours[3]]), jarctic.collate([ref[0], ref[3]]))
    dl = loader.DataLoader(ours, 3, seed=7, num_workers=2)
    jdl = jloader.DataLoader(ref, 3, seed=7, num_workers=2)
    try:
        assert len(dl) == len(jdl) == len(ours) // 3
        for epoch in (0, 1):
            dl.set_epoch(epoch)
            jdl.set_epoch(epoch)
            got, want = list(dl), list(jdl)
            assert len(got) == len(want) == len(dl)
            assert_same(got, want, f"epoch {epoch}")
        dl.set_epoch(0)
        first = next(iter(dl))
        dl.set_epoch(1)
        assert not np.array_equal(first["images"], next(iter(dl))["images"])
        tail = loader.DataLoader(ours, 5, shuffle=False, drop_last=False, num_workers=2)
        assert [b["images"].shape[0] for b in tail] == [5] * (len(ours) // 5) + (
            [len(ours) % 5] if len(ours) % 5 else [])
        tail.close()
    finally:
        dl.close()


def test_device_prefetch_on_the_cpu_converts_every_batch(roots):
    port_root, _ = roots
    ds = arctic.ArcticDataset(port_root, "p1", "val",
                              kp3d_cano=objects.synthetic_object_bank(2, device="cpu")
                              .kp_bottom.numpy())
    dl = loader.DataLoader(ds, 4, shuffle=False, num_workers=2)
    try:
        host = list(dl)
        got = list(loader.device_prefetch(dl, "cpu"))
    finally:
        dl.close()
    assert len(got) == len(host) > 1
    for g, h in zip(got, host):
        assert sorted(g) == sorted(h)
        for k in h:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            assert np.array_equal(g[k].numpy(), h[k]), k


def test_prefetch_samples_yields_each_chunk_in_order(roots):
    port_root, _ = roots
    ds = arctic.ArcticDataset(port_root, "p1", "val")
    chunks = [[0, 1], [5], [2, 2, 3]]
    got = list(loader.prefetch_samples(ds, chunks, ahead=2, workers=2))
    assert [[s["imgname"] for s in c] for c in got] == [[ds.imgnames[i] for i in c]
                                                         for c in chunks]


def test_native_image_path_is_refused(roots, tmp_path, monkeypatch):
    """Where the native library cannot be built, the native path is refused
    with the compiler's message (the JAX dataset turns it off quietly); the
    path itself is `tests/test_torch_native.py`'s."""
    from uvhand_tpu_torch import native

    bad = tmp_path / "broken.cpp"
    bad.write_text("not c++\n")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(native.NativeBuildError, match="error"):
        arctic.ArcticDataset(roots[0], "p1", "val", native_images="on")


def write_meta(path, names, seed=0):
    """A two-object ARCTIC meta directory in the official layout."""
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    meta = {}
    for k, name in enumerate(names):
        d = os.path.join(path, "object_vtemplates", name)
        os.makedirs(d)
        nv = 30 + 7 * k
        verts = rng.normal(scale=50.0, size=(nv, 3))
        with open(os.path.join(d, "mesh.obj"), "w") as f:
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for i in range(nv - 3):
                f.write(f"f {i + 1}/{i + 1} {i + 2} {i + 3} {i + 4}\n")  # quads, fan-split
        json.dump((rng.uniform(size=nv) > 0.5).tolist(), open(os.path.join(d, "parts.json"), "w"))
        for part in ("top", "bottom"):
            json.dump({"keypoints": rng.normal(scale=50.0, size=(300, 3)).tolist()},
                      open(os.path.join(d, f"{part}_keypoints_300.json"), "w"))
        json.dump({key: rng.normal(scale=50.0, size=(n, 3)).tolist() for key, n in (
            ("bbox_top", 8), ("bbox_bottom", 8), ("keypoints_top", 16),
            ("keypoints_bottom", 16))}, open(os.path.join(d, "object_params.json"), "w"))
        meta[name] = {"diameter": float(rng.uniform(0.1, 0.3))}
    json.dump(meta, open(os.path.join(path, "object_meta.json"), "w"))


def test_load_object_bank_equals_the_jax_loader(tmp_path):
    names = ("box", "laptop")
    write_meta(str(tmp_path), names)
    ours = objects.load_object_bank(str(tmp_path), names, device="cpu")
    ref = jobjects.load_object_bank(str(tmp_path), names)
    assert ours.names == ref.names == names
    for field in ("v", "mask", "v_len", "v_sub", "parts_ids", "parts_sub_ids", "bbox_top",
                  "bbox_bottom", "kp_top", "kp_bottom", "diameter"):
        a, b = getattr(ours, field), np.asarray(getattr(ref, field))
        assert a.device.type == "cpu"
        assert np.array_equal(a.numpy(), b), field
        assert a.numpy().dtype == b.dtype, field
    assert int(ours.v_len[1]) == 37
