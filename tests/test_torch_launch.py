"""The port over several processes (`uvhand_tpu_torch.train.launch`,
`train.mesh`, the sharded `DataLoader`, the global-batch train step, the
gathered eval, the merged meters and the CLI under torchrun), on the CPU.

  - `init_multihost`'s discovery (explicit arguments, then env
    RANK/WORLD_SIZE/MASTER_ADDR, then SLURM, else one process and no
    group) with `init_process_group` faked, as
    `tests/test_launch_multihost.py` holds the JAX launcher's;
  - the mesh helpers in one process (no-ops) and `rank_slice`;
  - `DataLoader(rank, world_size)`: the shares of every rank, in rank
    order, are the one-process batches, for 3 epochs, the short last batch
    of an eval loader included (a rank's share of it may be empty);
  - `MetricLogger.synchronize_between_processes` with an injected gather;
  - two processes under gloo (subprocesses, a tiny model: 12 queries, 1+2
    layers, d 64, FFN 128, 4 heads, dropout and feature mask 0, 128x128):
    2 AdamW steps of `make_fused_train_step(process_group=...)` on a global
    batch of 4 give both ranks the same loss dicts, equal to the port's
    one-process step (rtol 1e-5) and to the JAX package's step on the same
    batch and weights (the JAX suite's 1e-4 on loss terms; grad_norm, which
    a gradient W times too large would move, 1e-5 against the one-process
    step); one SGD step (lr 1, no clip) moves every parameter by its
    one-process gradient (1e-5 of each tensor's max: the test that a
    gradient W times too large, or a share of it, fails); the parameters
    after the 2 AdamW steps are equal on both ranks and agree with the
    one-process run to `tests/test_torch_train.py`'s bounds (Adam turns
    last-bit gradient differences into a fraction of lr wherever an
    element's gradient is near zero); `evaluate` over 7 frames at a global val batch of 4
    (rank 1's share of the last batch is one frame) equals the one-process
    scores (1e-6 relative: a mean over another order of the same rows);
    the meters merge; host rows gather with an empty rank; the DINO
    model's loss, each rank taking its rows of one injected global CDN
    draw, equals the one-process loss (1e-5);
    `broadcast_params` makes rank 1's parameters rank 0's;
  - the CLI under `torch.distributed.run` with 2 processes: a `--debug`
    epoch of one step and its eval, only rank 0 writing the checkpoint and
    results, then `--eval --resume` of that checkpoint, whose scores equal
    the end-of-epoch eval's.
All of them run at once (`launched`). Every worker and every process group
has a timeout, so a hung collective fails the test instead of holding the
suite.
"""

import datetime
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from uvhand_tpu_torch.data.loader import DataLoader
from uvhand_tpu_torch.train import launch, mesh
from uvhand_tpu_torch.train.state import label_params
from uvhand_tpu_torch.utils.logging import MetricLogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 128
CFG = dict(num_queries=12, num_encoder_layers=1, num_decoder_layers=2, d_model=64,
           n_heads=4, dim_feedforward=128, dropout=0.0, feature_mask_ratio=0.0)
STEPS = 2
#: seconds a worker may take before the test fails
WORKER_TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return env


def communicate(procs):
    """Wait for every process (each within WORKER_TIMEOUT_S); a failure or
    a timeout kills the rest and fails the test with the outputs."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed ({rc}):\n{out[-3000:]}\n{err[-6000:]}"
    return outs


# ------------------------------------------------------------ discovery


@pytest.fixture
def fake_init(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "SLURM_PROCID",
                "SLURM_NTASKS", "SLURM_STEP_NODELIST", "SLURM_LOCALID", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    return calls


def _timeout():
    return datetime.timedelta(seconds=launch.TIMEOUT_S)


def test_env_rank_discovery(fake_init, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.7")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    info = launch.init_multihost(device="cpu")
    assert fake_init == [(("gloo",), dict(init_method="env://", world_size=4, rank=2,
                                          timeout=_timeout()))]
    assert os.environ["MASTER_PORT"] == "1234"  # the JAX launcher's default port
    assert info["process_count"] == 1  # the faked call made no group


def test_slurm_discovery(fake_init, monkeypatch):
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_STEP_NODELIST", "node01,node02")
    launch.init_multihost(device="cpu", timeout_s=30)
    assert fake_init == [(("gloo",), dict(init_method="tcp://node01:29500", world_size=8,
                                          rank=3, timeout=datetime.timedelta(seconds=30)))]


def test_explicit_args_win_over_the_environment(fake_init, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.7")
    launch.init_multihost("host:1", 2, 1, backend="nccl-but-named", device="cpu")
    assert fake_init == [(("nccl-but-named",), dict(init_method="tcp://host:1", world_size=2,
                                                    rank=1, timeout=_timeout()))]


def test_single_process_noop(fake_init):
    info = launch.init_multihost(device="cpu")
    assert fake_init == []
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                    "global_devices": 1}
    assert launch.is_main_process()


def test_the_card_is_the_default_device(fake_init, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.7")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.init_multihost()
    assert fake_init == []


def test_local_rank(monkeypatch):
    for key in ("LOCAL_RANK", "SLURM_LOCALID"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert launch.local_rank(6) == 2
    monkeypatch.setenv("SLURM_LOCALID", "1")
    assert launch.local_rank(6) == 1
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert launch.local_rank(6) == 3


def test_mesh_helpers_are_noops_in_one_process():
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.gather_batch(x, 1) is x and mesh.gather_batch(None) is None
    rows = {"a": np.arange(3.0)}
    assert mesh.all_gather_rows(rows) is rows
    g = [x.clone()]
    mesh.all_reduce_grads(g)
    assert torch.equal(g[0], x)
    assert mesh.rank_slice(8) == slice(0, 8) and mesh.process_seed(5) == 5
    assert mesh.rank_slice(8, 1, 4) == slice(2, 4)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.rank_slice(6, 0, 4)


def test_buckets_split_by_size_and_type():
    ts = [torch.zeros(10), torch.zeros(10), torch.zeros(30), torch.zeros(5, dtype=torch.bfloat16),
          torch.zeros(1)]
    buckets = mesh._buckets(ts, cap=100)
    assert [[t.numel() for t in b] for b in buckets] == [[10, 10], [30], [5], [1]]
    assert [t for b in buckets for t in b] == ts


# ------------------------------------------------------------ the loader's shards


class _Frames:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": i}


def _ids(samples):
    return np.array([s["idx"] for s in samples])


@pytest.mark.parametrize("n, batch, shuffle, drop_last, world", [
    (20, 4, True, True, 2), (19, 6, True, True, 3), (7, 4, False, False, 2),
    (5, 4, False, False, 2)])
def test_loader_shards_make_the_one_process_batches(n, batch, shuffle, drop_last, world):
    kw = dict(shuffle=shuffle, drop_last=drop_last, num_workers=2, seed=3, collate_fn=_ids)
    one = DataLoader(_Frames(n), batch, **kw)
    ranks = [DataLoader(_Frames(n), batch, rank=r, world_size=world, **kw) for r in range(world)]
    try:
        for epoch in range(3):
            for dl in [one] + ranks:
                dl.set_epoch(epoch)
            want = list(one)
            got = [list(dl) for dl in ranks]
            assert all(len(dl) == len(one) for dl in ranks)
            for b, ids in enumerate(want):
                shares = [g[b] for g in got if b < len(g)]
                np.testing.assert_array_equal(np.concatenate(shares), ids)
                if len(ids) == batch:
                    assert all(len(s) == batch // world for s in shares)
            assert sum(len(g) for g in got) == sum(
                -(-len(ids) // (batch // world)) for ids in want)
    finally:
        for dl in [one] + ranks:
            dl.close()
    with pytest.raises(ValueError, match="does not divide"):
        DataLoader(_Frames(n), 5, rank=0, world_size=2)


def test_synchronize_between_processes_injected():
    a, b = MetricLogger(), MetricLogger()
    for v in (1.0, 2.0, 3.0):
        a.update(loss=v)
    for v in (10.0, 20.0):
        b.update(loss=v)
    states = {id(a): (3, 6.0), id(b): (2, 30.0)}

    def gather_for(me, other):
        return lambda arr: np.stack([arr, np.asarray(states[id(other)], np.float64)])

    a.synchronize_between_processes(allgather_fn=gather_for(a, b))
    b.synchronize_between_processes(allgather_fn=gather_for(b, a))
    for lg in (a, b):
        assert lg.meters["loss"].count == 5 and lg.meters["loss"].global_avg == 36.0 / 5
    one = MetricLogger()
    one.update(loss=4.0)
    one.synchronize_between_processes()  # no process group: a no-op
    assert one.meters["loss"].global_avg == 4.0


# ------------------------------------------------------------ two processes under gloo


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from uvhand_tpu_torch.train import launch, mesh
    from uvhand_tpu_torch.utils.logging import MetricLogger
    sys.path.insert(0, {tests!r})
    import test_torch_launch as t

    rank, port, root, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    info = launch.init_multihost(f"127.0.0.1:{{port}}", 2, rank, device="cpu", timeout_s=120)
    assert info == {{"process_index": rank, "process_count": 2, "local_devices": 1,
                    "global_devices": 2}}, info
    group = torch.distributed.group.WORLD
    res = {{"rank": rank}}

    # rank 1 starts from other weights: broadcast_params makes them rank 0's
    model = t.tiny_port(seed=rank)
    mesh.broadcast_params(model)
    lds, params, _ = t.train_run(model, root, group, rank, 2)
    delta = t.sgd_delta(root, group, rank, 2)
    res["dino"] = t.dino_loss(root, group, rank, 2)
    res["lds"], res["digest"] = lds, t.digest(params) + t.digest(delta)
    if rank == 0:  # rank 1's tensors are held against these by their digest
        res["params"], res["sgd_delta"] = params, delta
    res["scores"] = t.eval_run(root, rank, 2)

    logger = MetricLogger()
    for v in ((1.0, 2.0, 3.0), (10.0, 20.0))[rank]:
        logger.update(loss=v)
    logger.synchronize_between_processes()
    res["meter"] = [logger.meters["loss"].count, logger.meters["loss"].global_avg]
    rows = mesh.all_gather_rows({{"m": np.arange(3.0)}} if rank == 0 else {{}})
    res["rows"] = rows["m"].tolist()
    torch.save(res, f"{{out}}/rank{{rank}}.pt")
    torch.distributed.destroy_process_group()
""")
#: test_torch_train's learning rates and gradient tolerances by group
LR = {"general": 2e-4, "backbone": 2e-5, "linear_proj": 2e-5}
GRAD_TOL = {"general": 1e-4, "linear_proj": 1e-4, "backbone": 2e-3}


def digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for name, t in tensors.items():
        h.update(name.encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def tiny_port(seed=0, **kw):
    """The tiny model with seeded weights (`tests/test_torch_train.py`'s:
    the sampling offsets and attention weights drawn wider, so that the
    samples spread over the levels); `kw` changes the model."""
    from uvhand_tpu_torch.models.detr import UVHandDETR

    port = UVHandDETR(**CFG, **kw, generator=torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(1 + seed)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith(("sampling_offsets.weight", "attention_weights.weight")):
                p.copy_(torch.from_numpy(rng.normal(scale=0.05, size=p.shape).astype(np.float32)))
    return port


def tiny_world():
    from uvhand_tpu_torch.geometry import mano, objects

    return (mano.synthetic_mano(0, True, device="cpu"),
            mano.synthetic_mano(1, False, device="cpu"),
            objects.synthetic_object_bank(2, device="cpu"))


def dataset(root, split="train"):
    from uvhand_tpu_torch.data.arctic import ArcticDataset
    from uvhand_tpu_torch.geometry import objects

    bank = objects.synthetic_object_bank(2, device="cpu")
    return ArcticDataset(root, "p1", split, aug=False, img_res=RES,
                         kp3d_cano=bank.kp_bottom.numpy())


def first_batch(root, rank, world):
    """This rank's share of the first global batch of 4 training frames."""
    dl = DataLoader(dataset(root), 4, shuffle=False, num_workers=2, rank=rank,
                    world_size=world)
    try:
        return next(iter(dl))
    finally:
        dl.close()


def train_run(model, root, group, rank, world):
    """STEPS AdamW steps (clip 0.1) on the first global batch -> (loss
    dicts, parameters, each step's clipped gradients)."""
    from uvhand_tpu_torch import engine
    from uvhand_tpu_torch.train.state import create_optimizer

    step = engine.make_fused_train_step(model, *tiny_world(), create_optimizer(model),
                                        img_res=float(RES), device="cpu", process_group=group)
    batch = first_batch(root, rank, world)
    lds, grads = [], []
    for _ in range(STEPS):
        lds.append({k: float(v) for k, v in step(batch).items()})
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    return lds, {n: p.detach().clone() for n, p in model.named_parameters()}, grads


def sgd_delta(root, group, rank, world):
    """The parameters' move in one SGD step (lr 1, no clip): the gradient of
    the global batch's loss."""
    from uvhand_tpu_torch import engine

    model = tiny_port()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = engine.make_fused_train_step(model, *tiny_world(),
                                        torch.optim.SGD(model.parameters(), lr=1.0),
                                        img_res=float(RES), clip_max_norm=0.0, device="cpu",
                                        process_group=group)
    step(first_batch(root, rank, world))
    return {n: before[n] - p.detach() for n, p in model.named_parameters()}


def dino_loss(root, group, rank, world):
    """The DINO model's loss dict on the first global batch (train mode,
    dropout 0), every process taking its rows of one CDN draw made for the
    global batch (`dn_number` 2)."""
    from uvhand_tpu_torch import engine
    from uvhand_tpu_torch.models.dn import prepare_cdn

    model = tiny_port(dino_variant=True, use_dn=True, look_forward_twice=True,
                      dn_number=2).train()
    g = engine.to_device(first_batch(root, 0, 1), "cpu", engine.TRAIN_KEYS)
    t = engine.dn_targets(g)
    meta = prepare_cdn(torch.Generator().manual_seed(7), t["labels"], t["keypoints"],
                       t["target_valid"], 14, model.cdn)
    share = mesh.rank_slice(4, rank, world)
    loss_fn = engine.make_loss_fn(model, *tiny_world(), img_res=float(RES), process_group=group)
    with torch.no_grad():
        _, ld = loss_fn(engine.to_device(first_batch(root, rank, world), "cpu",
                                         engine.TRAIN_KEYS),
                        None, {k: v[share] for k, v in meta.items()})
    return {k: float(v) for k, v in ld.items()}


def eval_run(root, rank, world):
    """`evaluate` over the 7 validation frames at a global batch of 4."""
    from uvhand_tpu_torch import engine

    step = engine.make_eval_step(tiny_port(), *tiny_world(), img_res=float(RES), device="cpu")
    dl = DataLoader(dataset(root, "val"), 4, shuffle=False, drop_last=False, num_workers=2,
                    rank=rank, world_size=world)
    try:
        return engine.evaluate(step, dl)
    finally:
        dl.close()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from uvhand_tpu_torch.data.arctic import make_synthetic_root
    from uvhand_tpu_torch.geometry import objects

    path = str(tmp_path_factory.mktemp("data") / "arctic")  # the CLI's --coco_path is data/
    make_synthetic_root(path, num_seqs=1, frames=7, views=1,
                        obj_bank=objects.synthetic_object_bank(2, device="cpu"))
    return path


CLI = ["--device", "cpu", "--dataset_file", "arctic", "--two_stage", "--with_box_refine",
       "--enc_layers", "1", "--dec_layers", "1", "--hidden_dim", "64", "--dim_feedforward",
       "64", "--nheads", "4", "--num_queries", "12", "--dropout", "0.0", "--img_res", "128",
       "--batch_size", "4", "--val_batch_size", "4", "--debug", "--num_debug", "1",
       "--num_workers", "2", "--epochs", "1"]


def cli_runs(root, out):
    """The CLI under torchrun on 2 processes: a `--debug` epoch into
    out/train, then `--eval --resume` of its checkpoint into out/eval ->
    the first run's standard output."""
    def torchrun(*argv):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", "-m", "uvhand_tpu_torch.cli.main", *CLI,
               "--coco_path", os.path.dirname(root), *argv]
        (_, stdout, _), = communicate([subprocess.Popen(
            cmd, env=worker_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)])
        return stdout

    stdout = torchrun("--output_dir", f"{out}/train")
    torchrun("--output_dir", f"{out}/eval", "--eval", "--resume", f"{out}/train/0",
             "--eval_metrics", "aae", "mpjpe.ra", "mrrpe", "success_rate", "cdev")
    return stdout


@pytest.fixture(scope="module")
def launched(root, tmp_path_factory):
    """Every run of more than one process, started together: the two gloo
    workers and (in a thread) the CLI's torchrun runs; meanwhile, the
    one-process port run and the JAX package's run on the same batch and
    weights. -> (the workers' results, the one-process run's, JAX's loss
    dicts, the CLI's output directory and first standard output)."""
    out = str(tmp_path_factory.mktemp("ranks"))
    script = _WORKER.format(tests=os.path.dirname(os.path.abspath(__file__)))
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(port), root, out],
                              env=worker_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    cli = {}
    thread = threading.Thread(target=lambda: cli.update(stdout=cli_runs(root, f"{out}/cli")))
    thread.start()
    try:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            model = tiny_port()
            one = dict(zip(("lds", "params", "grads"), train_run(model, root, None, 0, 1)))
            one["labels"] = label_params(model)
            one["sgd_delta"] = sgd_delta(root, None, 0, 1)
            one["dino"] = dino_loss(root, None, 0, 1)
            one["scores"] = eval_run(root, 0, 1)
            jax_lds = jax_train_run(root)
        finally:
            torch.set_num_threads(n)
    finally:
        communicate(procs)
        thread.join(timeout=2 * WORKER_TIMEOUT_S)
    assert not thread.is_alive() and "stdout" in cli, "the CLI's torchrun runs failed"
    ranks = [torch.load(f"{out}/rank{r}.pt", weights_only=False) for r in range(2)]
    return ranks, one, jax_lds, f"{out}/cli", cli["stdout"]


@pytest.fixture(scope="module")
def two_ranks(launched):
    return launched[:3]


def jax_train_run(root):
    """STEPS steps of the JAX package's fused train step (its body: the
    loss's value and gradient, then the optimizer's update, each jitted)
    on the same global batch from the same weights -> loss dicts."""
    import jax
    import jax.numpy as jnp

    from uvhand_tpu import engine as jengine
    from uvhand_tpu.geometry import mano as jmano
    from uvhand_tpu.geometry import objects as jobjects
    from uvhand_tpu.models.detr import UVHandDETR as JaxDETR
    from uvhand_tpu.train.convert import convert_reference_detr
    from uvhand_tpu.train.state import create_train_state

    variables = convert_reference_detr(tiny_port().state_dict(), num_decoder_layers=2,
                                       num_encoder_layers=1, n_heads=4)
    jmodel = JaxDETR(**CFG)
    state = create_train_state(jmodel, variables, lr=2e-4, lr_backbone=2e-5, clip_max_norm=0.1)
    world = (jmano.synthetic_mano(0, True), jmano.synthetic_mano(1, False),
             jobjects.synthetic_object_bank(2))
    loss_fn = jengine.make_loss_fn(jmodel, *world, img_res=float(RES))

    @jax.jit
    def grads_of(params, batch, key):
        (_, ld), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch, key)
        ld["grad_norm"] = jengine.global_norm(grads)
        return ld, grads

    update = jax.jit(lambda state, grads: state.apply_gradients(grads=grads))
    batch = {k: jnp.asarray(v) for k, v in first_batch(root, 0, 1).items()}
    lds = []
    for i in range(STEPS):
        ld, grads = grads_of(state.params, batch, jax.random.PRNGKey(i))
        state = update(state, grads)
        lds.append({k: float(v) for k, v in ld.items()})
    return lds


def test_two_ranks_compute_the_global_batch_loss(two_ranks):
    """Every loss term of both steps, and step 1's grad_norm (which a
    gradient W times too large would move W-fold), within 1e-5 of the
    one-process step; step 2's grad_norm within 1e-3: the random ResNet-50
    amplifies step 1's float32 rounding in its backbone's gradient
    (`tests/test_torch_train.py`); against JAX, that file's tolerances."""
    ranks, one, jax_lds = two_ranks
    assert ranks[0]["lds"] == ranks[1]["lds"]
    for i, (ours, alone, ref) in enumerate(zip(ranks[0]["lds"], one["lds"], jax_lds)):
        assert set(ours) == set(alone) == set(ref)
        for k in ref:
            rtol = 1e-5 if (k != "grad_norm" or i == 0) else 1e-3
            np.testing.assert_allclose(ours[k], alone[k], rtol=rtol, atol=1e-7,
                                       err_msg=f"step {i + 1}: {k} against one process")
            rtol = 1e-4 if (k != "grad_norm" or i == 0) else 5e-3
            np.testing.assert_allclose(ours[k], ref[k], rtol=rtol, atol=1e-6,
                                       err_msg=f"step {i + 1}: {k} against JAX")


def test_two_ranks_sum_the_gradient_once(two_ranks):
    """One SGD step (lr 1, no clip) moves each parameter by its gradient:
    the two-rank gradient is the one-process gradient to 1e-5 of each
    tensor's max (a missing all-reduce would leave half of it, a mean
    instead of the sum another half, a double count twice it), and equal
    on both ranks."""
    ranks, one, _ = two_ranks
    assert ranks[0]["digest"] == ranks[1]["digest"]
    for name, want in one["sgd_delta"].items():
        got = ranks[0]["sgd_delta"][name]
        tol = 1e-5 * max(float(want.abs().max()), 1e-30)
        assert float((got - want).abs().max()) <= tol, (name, float(want.abs().max()))


def test_two_ranks_keep_the_parameters_of_the_one_process_run(two_ranks):
    """After 2 AdamW steps the parameters are equal on both ranks (their
    digest), and agree with the one-process run as `tests/test_torch_train.py`
    holds the port's run against JAX's after 3 steps (`assert_adam_close`)."""
    ranks, one, _ = two_ranks
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert_adam_close(ranks[0]["params"], one["params"], one["grads"], one["labels"])


def assert_adam_close(params, want_params, grads, labels):
    """`params` after AdamW steps against `want_params`, whose steps took
    the gradients `grads` (one dict a step): Adam's step divides each
    element's gradient by its own magnitude, so an element whose gradient
    lies under 10x its group's gradient tolerance of its tensor's max in
    some step (at most 60 % of them) has no well-defined step and is
    masked; outside the backbone the rest agree to 5e-2 lr (99 %: 5e-3
    lr), in it to 2 lr (99 %: 5e-2 lr)."""
    errs, masked, total = {g: [] for g in LR}, 0, 0
    for name, want in want_params.items():
        group = labels[name]
        floor, zero = torch.zeros_like(want, dtype=torch.bool), torch.ones_like(want,
                                                                                dtype=torch.bool)
        for g in grads:
            a = g[name].abs()
            floor |= a < 10 * GRAD_TOL[group] * max(float(a.max()), 1e-30)
            zero &= a == 0
        floor &= ~zero
        ulps = 2 * np.spacing(want.abs().numpy())
        err = np.maximum((params[name] - want).abs().numpy() - ulps, 0) / LR[group]
        errs[group].append(err[~floor.numpy()])
        masked += int(floor.sum())
        total += floor.numel()
    assert masked / total < 0.6, masked / total
    for group in LR:
        e = np.concatenate(errs[group])
        big, q99 = (2.0, 5e-2) if group == "backbone" else (5e-2, 5e-3)
        assert e.max() <= big and np.quantile(e, 0.99) <= q99, (group, e.max(),
                                                                np.quantile(e, 0.99))


def test_two_ranks_compute_the_global_dino_loss(two_ranks):
    """The DINO loss, each rank taking its rows of one injected global CDN
    draw, equals the one-process loss (1e-5): the dn outputs and their
    `dn_meta` are gathered, so the dn focal CE is normalised by the global
    `num_boxes`."""
    ranks, one, _ = two_ranks
    assert ranks[0]["dino"] == ranks[1]["dino"]
    assert {"loss_ce_dn", "loss_hand_keypoint_dn_0", "loss_obj_keypoint_dn"} <= set(one["dino"])
    assert set(ranks[0]["dino"]) == set(one["dino"])
    for k, v in one["dino"].items():
        np.testing.assert_allclose(ranks[0]["dino"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def test_two_ranks_evaluate_the_global_frames(two_ranks):
    ranks, one, _ = two_ranks
    assert ranks[0]["scores"] == ranks[1]["scores"]
    assert list(ranks[0]["scores"]) == list(one["scores"])
    for k, v in one["scores"].items():
        ours = ranks[0]["scores"][k]
        assert (np.isnan(v) and np.isnan(ours)) or abs(ours - v) <= 1e-6 * abs(v), (k, ours, v)


def test_two_ranks_merge_meters_and_rows(two_ranks):
    ranks, _, _ = two_ranks
    for r in ranks:
        assert r["meter"] == [5, 36.0 / 5]
        assert r["rows"] == [0.0, 1.0, 2.0]


# ------------------------------------------------------------ the CLI under torchrun


def test_the_cli_under_torchrun_trains_on_two_processes(launched):
    out, stdout = launched[3:]
    assert "'process_count': 2" in stdout and stdout.count("multihost:") == 1  # rank 0 prints
    assert sorted(os.listdir(f"{out}/train")) == ["0", "0.meta.json", "loss.txt", "results.txt",
                                                  "running_cmd.json"]
    assert os.listdir(f"{out}/train/0") == ["checkpoint.pth"]
    trained = open(f"{out}/train/results.txt").read().splitlines()
    assert len(trained) == 1 and len(open(f"{out}/train/loss.txt").read().splitlines()) == 1
    lines = open(f"{out}/eval/results.txt").read().splitlines()
    assert len(lines) == 2 and lines[0] == "========== 4*1, 0iter =========="
    resumed = json.loads(lines[1].replace("NaN", "null"))
    for k, v in json.loads(trained[0].replace("NaN", "null")).items():
        if k != "epoch":
            assert resumed[k] == v, (k, resumed[k], v)
