"""The model axis (`--mp`, `uvhand_tpu_torch.train.mesh`) on the CPU.

  - placement: for tiny models (two-stage, single-stage with the lstm
    temporal head, DINO with the vivit head), each parameter the port
    shards holds, on each mp rank, exactly the elements of its JAX leaves
    that `uvhand_tpu/train/mesh.py::param_sharding_for_path` puts on that
    rank (`make_mesh(mp=2)` on the conftest's 8 CPU devices, min_size
    4096, as `tests/test_train_e2e.py`), and every other parameter comes
    from leaves the JAX rule replicates. The leaves are told apart by
    value: each leaf of the JAX tree (its shapes from `jax.eval_shape`) is
    filled with its index and its column, then mapped by the port's
    converter (`state_dict_from_jax`) onto the port's names;
  - the step: four gloo processes (dp 2 x mp 2, `make_mesh(2)`) take two
    fused AdamW steps of a tiny model (d 64, FFN 128, 12 queries, 1+2
    layers, 128x128, a global batch of 4, min_size 4096) and match one
    process's: loss terms within 1e-4, the clip's global norm within 1e-4
    (relative: torch's float32 norm of the 5.5 M-element `pos_trans.0`
    gradient on the CPU is 6e-5 off its float64 value, and its halves'
    norms are off otherwise), the gathered parameters and AdamW moments within 1e-3 of
    each tensor's max; each rank holds 1/mp of every sharded weight and of
    its moments, before and after the steps, and the backbone, the biases
    and the norms whole; every rank gathers the same whole tensors (rank 0
    saves them, the others their digest); a checkpoint written at mp 2
    loads at mp 1 (equal to the gathered tensors) and back at mp 2 into a fresh sharded model
    and optimizer (each rank its rows); with bfloat16 parameters
    (stochastic rounding) the float32 copies shard too, the draws are the
    one process's, and two steps match one process's within one bfloat16
    step of each tensor's max;
  - `make_mesh` and the CLI's check refuse processes that do not divide by
    mp.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from uvhand_tpu_torch.train import checkpoint as ckpt
from uvhand_tpu_torch.train import mesh

from test_torch_launch import (RES, assert_adam_close, communicate, digest,  # noqa: F401
                               first_batch, free_port, root, tiny_port, tiny_world, worker_env)

MIN_SIZE = 4096
STEPS = 2

# ------------------------------------------------------------ placement

PLACEMENT_CFG = dict(num_queries=40, num_encoder_layers=1, num_decoder_layers=1, d_model=64,
                     n_heads=4, dim_feedforward=128, dropout=0.0, feature_mask_ratio=0.0)
VARIANTS = {
    "two_stage": dict(two_stage=True, with_box_refine=True),
    "single_stage_lstm": dict(two_stage=False, with_box_refine=False, temporal_head="lstm",
                              temporal_window=3),
    "dino_vivit": dict(two_stage=True, with_box_refine=True, dino_variant=True, use_dn=True,
                       look_forward_twice=True, dn_number=2, temporal_head="vivit",
                       temporal_window=3),
}
#: a leaf's values: index * TAG + its column (its last axis)
TAG = 4096


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_placement_is_the_jax_rule_leaf_for_leaf(variant):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from uvhand_tpu import engine as jengine
    from uvhand_tpu.models.detr import UVHandDETR as JaxDETR
    from uvhand_tpu.train import mesh as jmesh
    from uvhand_tpu_torch.models.detr import UVHandDETR
    from uvhand_tpu_torch.train.convert import state_dict_from_jax

    cfg = {**PLACEMENT_CFG, **VARIANTS[variant]}
    jmodel = JaxDETR(**cfg)
    shapes = jax.eval_shape(lambda: jengine.init_params(jmodel, jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 128, 128, 3))))
    jm = jmesh.make_mesh(mp=2)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    sharded = {}  # leaf index -> its columns' count, for the leaves JAX shards
    tagged = []
    for i, (path, x) in enumerate(leaves):
        spec = jmesh.param_sharding_for_path(jm, path, x, min_size=MIN_SIZE).spec
        assert spec in (P(), P(None, "mp")), spec
        if spec == P(None, "mp"):
            sharded[i] = x.shape[-1]
        cols = np.arange(x.shape[-1]) if x.ndim else 0
        tagged.append(np.broadcast_to(i * TAG + cols, x.shape).astype(np.float32))
    assert sharded, "no leaf of the tiny model shards: the test would hold nothing"
    sd = state_dict_from_jax(jax.tree_util.tree_unflatten(treedef, tagged))

    port = UVHandDETR(**cfg, device="cpu")
    assert set(sd) == set(port.state_dict())
    placed = mesh.param_placement(port, 2, MIN_SIZE)
    n_sharded = 0
    for name, _ in port.named_parameters():
        t = sd[name]
        ids, cols = torch.div(t, TAG, rounding_mode="floor").long(), t.long() % TAG
        src = {int(i) for i in ids.unique()}
        if name not in placed:
            assert not src & set(sharded), f"{name}: JAX shards its leaves {src & set(sharded)}"
            continue
        n_sharded += 1
        assert src <= set(sharded), f"{name}: JAX replicates its leaves {src - set(sharded)}"
        width = torch.tensor([sharded.get(int(i), 1) for i in ids.flatten()]).view(t.shape)
        for r in range(2):
            want = t[(cols * 2 // width) == r]  # the columns on JAX's mp rank r
            got = mesh.Shard(mesh.Mesh(1, 2, 0, r), *placed[name]).local(t)
            assert got.numel() * 2 == t.numel()
            assert torch.equal(got.flatten().sort().values, want.sort().values), (name, r)
    assert n_sharded == len({n for n in placed}) and n_sharded >= 4
    if variant == "single_stage_lstm":
        assert placed["query_embed.weight"] == (1, 1)  # an embedding: flax's layout
        assert placed["temporal_param_head.ta_pose_r.bilstm.lstm.weight_ih_l0"] == (0, 4)
    assert not any(n.startswith("backbone.0.") for n in placed)


def test_make_mesh_and_the_cli_refuse_what_does_not_divide():
    assert mesh.check_axes(4, 2) is None and mesh.check_axes(1, 1) is None
    for world, mp in ((1, 2), (3, 2), (4, 8)):
        assert "do not divide into dp x mp" in mesh.check_axes(world, mp)
    one = mesh.make_mesh(1)
    assert (one.dp, one.mp, one.dp_rank, one.mp_rank, one.dp_group, one.mp_group) == (
        1, 1, 0, 0, None, None)
    with pytest.raises(ValueError, match="--mp 2"):
        mesh.make_mesh(2)


# ------------------------------------------------------------ four processes

_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    from uvhand_tpu_torch.train import checkpoint as ckpt, launch, mesh
    sys.path.insert(0, {tests!r})
    import test_torch_mp as t

    rank, port, root, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    launch.init_multihost(f"127.0.0.1:{{port}}", 4, rank, device="cpu", timeout_s=120)
    grid = mesh.make_mesh(2)
    res = {{"rank": rank, "dp_rank": grid.dp_rank, "mp_rank": grid.mp_rank}}
    res.update(t.run_steps(root, grid, out))
    # every rank holds the same whole tensors: rank 0 saves them, the others their digest
    res["digest"] = t.digest(res["params"]) + t.digest(res["moments"])
    if rank:
        del res["params"], res["moments"]
    bf16 = t.run_steps(root, grid, None, bf16=True)
    res["bf16"] = {{k: bf16[k] for k in ("lds", "held_after", "sharded")}}
    res["bf16"]["dtypes"] = {{n: str(v.dtype) for n, v in bf16["params"].items()
                             if v.is_floating_point()}}
    torch.save(res, f"{{out}}/rank{{rank}}.pt")
    torch.distributed.destroy_process_group()
""")


def run_steps(root, grid, out, bf16=False):
    """STEPS fused AdamW steps of the tiny model on the first global batch,
    sharded over `grid` (None: one process) -> loss dicts, the whole
    parameters and moments after them, and what this process held."""
    from uvhand_tpu_torch import engine
    from uvhand_tpu_torch.train.state import create_optimizer, label_params

    model = tiny_port(**({"param_dtype": torch.bfloat16} if bf16 else {}))
    optimizer = create_optimizer(model)
    res = {}
    if grid is not None:
        res["placed"] = mesh.param_placement(model, grid.mp, MIN_SIZE)
        shards = mesh.shard_state(grid, model, optimizer, min_size=MIN_SIZE)
        res["sharded"] = sorted(shards)
        res["held_before"] = held(model, optimizer)
    step = engine.make_fused_train_step(
        model, *tiny_world(), optimizer, img_res=float(RES), device="cpu",
        process_group=None if grid is None else grid.dp_group,
        model_group=None if grid is None else grid.mp_group)
    batch = first_batch(root, 0, 1) if grid is None else first_batch(root, grid.dp_rank,
                                                                      grid.dp)
    res["lds"], res["grads"] = [], []
    for _ in range(STEPS):
        res["lds"].append({k: float(v) for k, v in step(batch).items()})
        if grid is None:
            res["grads"].append({n: p.grad.clone() for n, p in model.named_parameters()})
    if grid is None:
        res["labels"] = label_params(model)
    else:
        res["held_after"] = held(model, optimizer)
    res["params"] = {k: v.clone() for k, v in mesh.whole_state_dict(model).items()}
    res["moments"] = moments(model, optimizer)
    if out is not None:
        path = ckpt.save_checkpoint(out, 0, model, optimizer, step=STEPS)
        if grid is not None:  # back at mp 2 into a fresh sharded model and optimizer
            fresh = tiny_port(seed=3)
            fresh_opt = create_optimizer(fresh)
            mesh.shard_state(grid, fresh, fresh_opt, min_size=MIN_SIZE)
            res["reload"] = ckpt.load_checkpoint(path, fresh, fresh_opt)
            res["reload_equal"] = all(
                torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                  model.state_dict().values())) and all(
                torch.equal(x, y) for a, b in zip(optimizer.state.values(),
                                                  fresh_opt.state.values())
                for x, y in zip(a.values(), b.values()))
    return res


def held(model, optimizer):
    """What this process holds: each parameter's shape (the reference's
    names) and each optimizer tensor's shape, by the parameter's name."""
    names = {id(p): mesh.whole_name(n) for n, p in model.named_parameters()}
    out = {names[id(p)]: tuple(p.shape) for p in model.parameters()}
    copies = [p for g in optimizer.param_groups for p in g["params"]]
    owners = getattr(optimizer, "bf16_params", copies)
    for p, q in zip(owners, copies):
        out[names[id(p)] + "@copy"] = tuple(q.shape)
        for k, v in optimizer.state.get(q, {}).items():
            if v.dim():
                out[f"{names[id(p)]}@{k}"] = tuple(v.shape)
    return out


def moments(model, optimizer):
    """AdamW's moments of every parameter, whole, by the parameter's name."""
    names = [mesh.whole_name(n) for n, _ in model.named_parameters()]
    state = mesh.whole_optimizer_state(optimizer)["state"]
    index = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])}
    copies = [p for g in optimizer.param_groups for p in g["params"]]
    owners = getattr(optimizer, "bf16_params", copies)
    by_param = {id(p): index[id(q)] for p, q in zip(owners, copies)}
    return {f"{n}@{k}": state[by_param[id(p)]][k].clone()
            for n, p in zip(names, model.parameters()) for k in ("exp_avg", "exp_avg_sq")}


@pytest.fixture(scope="module")
def four(root, tmp_path_factory):
    """The four workers (dp 2 x mp 2) and, meanwhile, one process."""
    out = str(tmp_path_factory.mktemp("mp"))
    script = _WORKER.format(tests=os.path.dirname(os.path.abspath(__file__)))
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(port), root, out],
                              env=worker_env(), cwd=os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    try:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = run_steps(root, None, None)
            one_bf16 = run_steps(root, None, None, bf16=True)
        finally:
            torch.set_num_threads(n)
    finally:
        communicate(procs)
    ranks = [torch.load(f"{out}/rank{r}.pt", weights_only=False) for r in range(4)]
    return ranks, one, one_bf16, out


def close(a, b, tol):
    scale = max(float(b.abs().max()), 1e-12)
    return float((a.float() - b.float()).abs().max()) <= tol * scale


def test_four_processes_step_as_one(four):
    ranks, one, _, _ = four
    assert [(r["dp_rank"], r["mp_rank"]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        for got, want in zip(r["lds"], one["lds"]):
            assert set(got) == set(want)
            for k, v in want.items():
                assert abs(got[k] - v) <= 1e-4 * max(abs(v), 1.0), (k, got[k], v)
            # the clip's global norm: each shard counted once
            assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-4 * want["grad_norm"]
    # the whole tensors are the same on every rank (rank 0 saved them, the
    # others their digest)
    assert len({r["digest"] for r in ranks}) == 1
    for name, want in one["moments"].items():
        assert close(ranks[0]["moments"][name], want, 1e-3), name
    # Adam's steps of near-zero gradients are masked, as the two dp ranks'
    assert_adam_close(ranks[0]["params"], {n: one["params"][n] for n in one["labels"]},
                      one["grads"], one["labels"])


def test_each_rank_holds_its_shards_only(four):
    ranks, one, _, _ = four
    placed = ranks[0]["placed"]
    assert sorted(placed) == ranks[0]["sharded"] and len(placed) >= 4
    assert any(n.endswith("linear1.weight") for n in placed)
    for name in one["params"]:
        if name.startswith("backbone.0.") or name.endswith(("bias", "norm1.weight",
                                                            "norm2.weight", "norm3.weight")):
            assert name not in placed, name
    for r in ranks:
        assert r["placed"] == placed
        for when in ("held_before", "held_after"):
            for key, shape in r[when].items():
                name = key.split("@")[0]
                whole = tuple(one["params"][name].shape)
                if name in placed:  # 1/mp of the rows, the moments too
                    dim = placed[name][0]
                    assert shape == tuple(s // 2 if d == dim else s
                                          for d, s in enumerate(whole)), (when, key)
                else:
                    assert shape == whole, (when, key)


def test_a_checkpoint_written_at_mp2_loads_at_mp1(four):
    from uvhand_tpu_torch.train.state import create_optimizer

    ranks, _, _, out = four
    assert all(r["reload"]["optimizer_restored"] and r["reload_equal"] for r in ranks)
    model = tiny_port(seed=3)
    optimizer = create_optimizer(model)
    info = ckpt.load_checkpoint(os.path.join(out, "0"), model, optimizer)
    assert info == {"step": STEPS, "epoch": 0, "optimizer_restored": True}
    for name, p in model.state_dict().items():
        assert torch.equal(p, ranks[0]["params"][name]), name
    for key, want in moments(model, optimizer).items():
        assert torch.equal(ranks[0]["moments"][key], want), key


def test_bf16_parameters_shard_their_copies(four):
    """With bfloat16 parameters the stochastic-rounding optimizer's float32
    copies and moments keep the shard's rows too, and the loss of the two
    steps is one process's (1e-2: SR's draws round the last bits)."""
    ranks, _, one_bf16, _ = four
    for r in ranks:
        b = r["bf16"]
        held_ = b["held_after"]
        assert b["sharded"] == r["sharded"]
        for name in b["sharded"]:
            assert held_[name + "@copy"] == held_[name] == held_[name + "@exp_avg"]
            assert np.prod(held_[name]) * 2 == np.prod(one_bf16["params"][name].shape)
        for got, want in zip(b["lds"], one_bf16["lds"]):
            assert abs(got["total"] - want["total"]) <= 1e-2 * abs(want["total"])
        assert set(b["dtypes"].values()) == {"torch.bfloat16"}


@pytest.mark.parametrize("dim, blocks", [(0, 1), (1, 1), (0, 4)])
def test_a_shard_takes_its_rows_of_the_whole_draws(dim, blocks):
    """One SR AdamW step of a sharded bfloat16 parameter, on each mp rank's
    rows of the gradient, gives that rank's rows of the one-process step bit
    for bit: the draws are the whole parameter's, cut to the rows."""
    from uvhand_tpu_torch.train.state import SRAdamW

    gen = torch.Generator().manual_seed(0)
    whole = torch.randn(8, 12, generator=gen).to(torch.bfloat16)
    grad = torch.randn(8, 12, generator=gen)
    p = torch.nn.Parameter(whole.clone())
    one = SRAdamW([{"params": [p]}], lr=1e-2, sr_seed=5)
    one.step(grads=[grad])
    for r in range(2):
        shard = mesh.Shard(mesh.Mesh(1, 2, 0, r), dim, blocks)
        q = torch.nn.Parameter(shard.local(whole).contiguous())
        q.mp_shard = shard
        opt = SRAdamW([{"params": [q]}], lr=1e-2, sr_seed=5)
        opt.step(grads=[shard.local(grad).contiguous()])
        assert torch.equal(q.detach(), shard.local(p.detach())), r
