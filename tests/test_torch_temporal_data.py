"""The port's temporal windows and collates against the JAX package's, on
the CPU.

Two synthetic ARCTIC roots (`make_synthetic_root`, small images): one
sequence of 24 frames in 2 views, long enough that `TempoTrainDataset`
clips its windows to [10, n - 11] as the reference does, and one of 5
frames, where it falls back to the widest valid range. Each root is read by
both packages' `ArcticDataset`; on them `create_windows`, `WindowDataset`,
`TempoTrainDataset` (an odd and an even window, `split_window` both ways),
`collate_tempo_train` and `collate_windows` must give the JAX package's
arrays bit for bit (numpy and cv2 in both, the same draws in the same
order). Two `DataLoader` rank shares of window batches, put together with
the second share's `center_index` rebased, must equal the one-process
batch. No JAX program runs here.
"""

import functools

import numpy as np
import pytest

from uvhand_tpu.data import arctic as jarctic
from uvhand_tpu_torch.data import arctic, loader
from uvhand_tpu_torch.geometry import objects

from test_torch_data import assert_same
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

ROOTS = {"long": dict(num_seqs=1, frames=24, views=2), "short": dict(num_seqs=2, frames=5,
                                                                     views=1)}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """{root: (port ArcticDataset, JAX ArcticDataset)} on the same files."""
    bank = objects.synthetic_object_bank(2, device="cpu")
    out = {}
    for name, kw in ROOTS.items():
        root = str(tmp_path_factory.mktemp(name))
        arctic.make_synthetic_root(root, seed=5, image_hw=(120, 168), obj_bank=bank, **kw)
        cano = bank.kp_bottom.numpy()
        out[name] = (arctic.ArcticDataset(root, "p1", "train", kp3d_cano=cano, img_res=64),
                     jarctic.ArcticDataset(root, "p1", "train", kp3d_cano=cano, img_res=64))
    return out


@pytest.mark.parametrize("window", [3, 4])
@pytest.mark.parametrize("root", sorted(ROOTS))
def test_window_datasets_equal_the_jax_packages(datasets, root, window):
    ds, jds = datasets[root]
    assert arctic.create_windows(ds.imgnames, window) == jarctic.create_windows(
        jds.imgnames, window)
    wds, jwds = arctic.WindowDataset(ds, window), jarctic.WindowDataset(jds, window)
    assert len(wds) == len(jwds) and len(wds) > 1
    for i in range(len(wds)):
        assert_same(wds[i], jwds[i], f"window {i}")
    assert_same(arctic.collate_windows([wds[i] for i in range(2)]),
                jarctic.collate_windows([jwds[i] for i in range(2)]), "collate_windows")


@pytest.mark.parametrize("split", [True, False], ids=["split", "centre"])
@pytest.mark.parametrize("window", [3, 4])
@pytest.mark.parametrize("root", sorted(ROOTS))
def test_tempo_train_windows_and_collate_equal_the_jax_packages(datasets, root, window, split):
    ds, jds = datasets[root]
    tds = arctic.TempoTrainDataset(ds, window, split_window=split)
    jtds = jarctic.TempoTrainDataset(jds, window, split_window=split)
    assert len(tds) == len(jtds) == len(ds)
    items = [tds[i] for i in range(len(tds))]
    for i, item in enumerate(items):
        assert_same(item, jtds[i], f"item {i}")
        assert item["center_pos"].dtype == np.int32
    # the windows' frames: truncated offsets, clipped (long: to [10, 13])
    n = ROOTS[root]["frames"]
    lo = min(10, (n - 1) // 2)
    hi = max(n - 11, lo)
    assert (lo, hi) == ((10, 13) if root == "long" else (2, 2))
    for pos in (0, n // 2, n - 1):
        names = items[pos]["imgname"]
        frames = [int(s.split("/")[-1].split(".")[0]) for s in names]
        ind = np.clip((np.arange(window) - (window - 1) / 2 + pos).astype(np.int64), lo, hi)
        assert frames == list(ind)
        assert items[pos]["center_pos"] == np.argmin(np.abs(ind - np.clip(pos, lo, hi)))
    picks = [0, len(items) // 2, len(items) - 1]
    batch = arctic.collate_tempo_train([items[i] for i in picks], split_window=split)
    assert_same(batch, jarctic.collate_tempo_train([jtds[i] for i in picks],
                                                   split_window=split), "collate_tempo_train")
    assert batch["images"].shape[0] == 3 * window
    if split:
        assert "center_index" not in batch and batch["is_valid"].shape[0] == 3 * window
    else:
        assert batch["is_valid"].shape[0] == 3
        centres = np.array([items[i]["center_pos"] for i in picks])
        assert batch["center_index"].tolist() == (np.arange(3) * window + centres).tolist()


def test_two_rank_shares_of_window_batches_make_the_one_process_batch(datasets):
    """Each rank collates its whole windows; the shares in rank order, the
    second's `center_index` rebased by the first's frames, are the
    one-process batch."""
    ds, _ = datasets["long"]
    window, windows = 4, 4
    tds = arctic.TempoTrainDataset(ds, window, split_window=False)
    collate = functools.partial(arctic.collate_tempo_train, split_window=False)

    def batches(**shard):
        dl = loader.DataLoader(tds, windows, seed=1, num_workers=2, collate_fn=collate, **shard)
        try:
            return list(dl)
        finally:
            dl.close()

    one = batches()
    shares = [batches(rank=r, world_size=2) for r in range(2)]
    assert len(one) == len(shares[0]) == len(shares[1]) == len(tds) // windows
    for b, s0, s1 in zip(one, *shares):
        assert s0["images"].shape[0] == s1["images"].shape[0] == 2 * window
        rebased = dict(s1, center_index=s1["center_index"] + s0["images"].shape[0])
        joined = {k: np.concatenate([s0[k], rebased[k]]) for k in b}
        assert_same(joined, b, "joined shares")
