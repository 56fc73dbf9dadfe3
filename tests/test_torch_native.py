"""The port's native image path (`uvhand_tpu_torch/native/`) on the CPU.

The port's copy of `pipeline.cpp` is built with this host's g++ into
`build/native/`, as the JAX package's own is built into its cache: the two
libraries run the same source, so `process_image` must equal the JAX
package's native call bit for bit, in the full and the fast decode. Against
the port's Python path (cv2 + `augment`) the full decode stays within the
JAX package's own bound, 0.08 in normalized units (decoder rounding through
the cubic warp). The dataset with `native_images="on"` equals the one with
"off" in every key but the image, and the JAX package's native dataset in
every key; a missing file takes the Python path (zero image, is_valid 0),
and a library that cannot be built raises with the compiler's message.
"""

import numpy as np
import pytest

from uvhand_tpu import native as jnative
from uvhand_tpu.data import arctic as jarctic
from uvhand_tpu_torch import native
from uvhand_tpu_torch.data import arctic, augment


def _jpg(path, rng, smooth=False):
    import cv2

    img = rng.uniform(0, 255, (600, 840, 3)).astype(np.uint8)
    if smooth:
        img = cv2.GaussianBlur(img, (7, 7), 3)
    cv2.imwrite(str(path), img)
    return str(path)


def _python_path(p, center, bbox_dim, augm, res=224):
    import cv2

    img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB).astype(np.float32)
    return augment.normalize_image(augment.rgb_processing(img, center, bbox_dim, augm, res))


CASES = [  # (center, bbox_dim, rot, sc): interior, two corners, no rotation
    ([410.0, 290.0], 1.4, 12.0, 1.1),
    ([30.0, 20.0], 1.5, -25.0, 0.9),
    ([830.0, 590.0], 1.2, 0.0, 1.0),
]


@pytest.mark.parametrize("fast", [False, True], ids=["full", "fast"])
def test_process_image_equals_the_jax_packages_native_call(fast, tmp_path):
    assert jnative.available()
    rng = np.random.default_rng(0)
    paths = [_jpg(tmp_path / "a.jpg", rng), _jpg(tmp_path / "s.jpg", rng, smooth=True)]
    for p in paths:
        for center, bbox_dim, rot, sc in CASES:
            augm = {"rot": rot, "sc": sc, "pn": np.array([0.95, 1.02, 1.05], np.float32),
                    "flip": 0}
            ours = native.process_image(p, center, bbox_dim, augm, 224, fast=fast)
            ref = jnative.process_image(p, center, bbox_dim, augm, 224, fast=fast)
            assert ours is not None and ours.dtype == np.float32
            np.testing.assert_array_equal(ours, ref)
            if not fast:
                d = np.abs(ours - _python_path(p, center, bbox_dim, augm))
                assert d.max() < 0.08 and d.mean() < 5e-3, (d.max(), d.mean())


def test_the_dataset_routes_each_image_and_counts_it(tmp_path):
    root = str(tmp_path / "arctic")
    arctic.make_synthetic_root(root, num_seqs=1, frames=3, views=2, seed=0)
    kw = dict(setup="p1", split="train")
    off, on = arctic.ArcticDataset(root, **kw), arctic.ArcticDataset(root, native_images="on",
                                                                     **kw)
    ref = jarctic.ArcticDataset(root, native_images="on", **kw)
    assert ref.native_images == "on"
    for i in range(len(off)):
        a, b, c = off[i], on[i], ref[i]
        assert set(a) == set(b) == set(c)
        assert np.abs(a["images"] - b["images"]).max() < 0.08
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(c[k]), err_msg=k)
            if k != "images":
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    n = len(off)
    assert dict(off.image_routes) == {"python": n} and dict(on.image_routes) == {"native": n}

    # a missing file: the C call cannot decode it, the Python path gives the
    # zero image and is_valid 0, as in the JAX package
    import os

    name = on.imgnames[0]
    os.remove(on._img_path(name))
    miss, jmiss = on[0], ref[0]
    assert miss["is_valid"] == 0 and jmiss["is_valid"] == 0
    np.testing.assert_array_equal(miss["images"], jmiss["images"])
    np.testing.assert_array_equal(miss["images"], augment.normalize_image(np.zeros(
        (224, 224, 3), np.float32)))
    assert on.image_routes["fallback"] == 1


def test_a_library_that_cannot_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( { return 0; }\n")
    with pytest.raises(native.NativeBuildError, match="error"):
        native.build(source=bad, build_dir=tmp_path / "out")
    assert not list((tmp_path / "out").glob("*.so"))

    # the dataset raises with the compiler's message, it does not fall back
    root = str(tmp_path / "arctic")
    arctic.make_synthetic_root(root, num_seqs=1, frames=2, views=1, seed=0)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out2")
    for mode in ("on", "fast"):
        with pytest.raises(native.NativeBuildError, match="error"):
            arctic.ArcticDataset(root, "p1", "train", native_images=mode)
    with pytest.raises(ValueError, match="native_images"):
        arctic.ArcticDataset(root, "p1", "train", native_images="auto")
