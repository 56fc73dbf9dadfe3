"""The (dp, mp) mesh over processes: the data axis and the model axis.

Port of `uvhand_tpu/train/mesh.py`. The data axis: the JAX package shards
the global batch over a mesh axis and computes one loss over it in one
program; here each process holds a contiguous share of the global batch's
rows (`rank_slice`), and the train step gathers the outputs that the
criterion reads (`gather_batch`), so that every process computes the loss
of the global batch, then sums the gradients (`all_reduce_grads`). Every
helper is a no-op where no process group exists.

The model axis (`make_mesh(mp=...)`, `--mp`): the processes form a (dp, mp)
mesh, mp the fastest-varying axis, as the JAX package's `make_mesh` lays
out its devices; the mp processes of one dp row hold the same batch rows.
A parameter that the JAX package's rule shards (`param_sharding_for_path`:
a 2-D leaf of at least `min_size` elements whose output axis divides by mp,
never under `backbone`), judged on its JAX layout through the converter's
name map (`convert.leaf_layouts`), holds 1/mp of the JAX output axis on
each mp process: dim 0 of a `Linear` weight (torch's (out, in)), dim 1 of
an embedding or a bare 2-D parameter (flax's layout), each gate's rows of
an `nn.LSTM` weight. `shard_params` makes such a parameter a plain tensor
of its shard (`shard.mp_shard` says which) and registers a parametrization
that gathers the whole weight over the mp group where the model reads it;
its backward gives the shard its rows of the whole weight's gradient. The
AdamW moments, and with bfloat16 parameters the stochastic-rounding
copies, shard with their parameters (`shard_state`), and so do the
updates: a process holds and steps only its shards, before and after a
step. The forward and backward run whole on every mp process (the JAX
package lets XLA place them); what is sharded is what the JAX rule
shards: the weights, their gradients after the backward, and their
optimizer state. Plain tensors, not `torch.distributed.tensor.DTensor`:
the optimizers' foreach kernels and the MSDA kernels take lists and
tensors of one kind.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

#: kernels smaller than this stay replicated (the JAX package's threshold)
MP_MIN_SIZE = 16384

#: bytes of one flat buffer of `all_reduce_grads` (arctic_sf's float32
#: gradients, ~160 MB, go in 3 buffers)
BUCKET_BYTES = 64 << 20


def active() -> bool:
    """True where a default process group exists."""
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> tuple:
    return (dist.get_rank(), dist.get_world_size()) if active() else (0, 1)


def rank_slice(global_batch_size: int, rank: Optional[int] = None,
               world_size: Optional[int] = None) -> slice:
    """The rows of a global batch that process `rank` of `world_size` (the
    default group's where not given) holds: a contiguous share, in rank
    order. Raises where the batch does not divide by the world size, as the
    JAX package's `shard_batch` does."""
    if rank is None or world_size is None:
        rank, world_size = rank_and_world()
    if global_batch_size % world_size:
        raise ValueError(f"a global batch of {global_batch_size} does not divide over "
                         f"{world_size} processes")
    n = global_batch_size // world_size
    return slice(rank * n, (rank + 1) * n)


def _buckets(tensors: Sequence[torch.Tensor], cap: int) -> List[List[torch.Tensor]]:
    """`tensors` in runs of one dtype and device, each of at most `cap` bytes
    (or one tensor)."""
    out, size = [], 0
    for t in tensors:
        if (not out or size + t.numel() * t.element_size() > cap
                or (t.dtype, t.device) != (out[-1][0].dtype, out[-1][0].device)):
            out.append([])
            size = 0
        out[-1].append(t)
        size += t.numel() * t.element_size()
    return out


def _coalesced(tensors: Sequence[torch.Tensor], collective, cap: int = BUCKET_BYTES) -> None:
    """Run `collective(flat)` on flat copies of `tensors`, a few buffers of
    at most `cap` bytes, and write the results back into them."""
    for bucket in _buckets(tensors, cap):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective(flat)
        views = [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in bucket]), bucket)]
        torch._foreach_copy_(bucket, views)


def all_reduce_grads(grads: Sequence[torch.Tensor], group=None) -> None:
    """Sum `grads` (tensors, in place) over the processes of `group` (the
    default group): a few flat buffers, not one call a tensor."""
    if active():
        _coalesced(list(grads), lambda flat: dist.all_reduce(flat, group=group))


def broadcast_grads(grads: Sequence[torch.Tensor], group) -> None:
    """`grads` (in place) from the first process of `group` to the others."""
    if active() and grads:
        src = dist.get_global_rank(group, 0)
        _coalesced(list(grads), lambda flat: dist.broadcast(flat, src, group=group))


@torch.no_grad()
def broadcast_params(model: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `model` from process `src`; a shard
    from the process of dp rank 0 that holds the same rows of it."""
    if active():
        tensors = list(model.parameters()) + list(model.buffers())
        whole = [t.data for t in tensors if not hasattr(t, "mp_shard")]
        _coalesced(whole, lambda flat: dist.broadcast(flat, src))
        shards = [t for t in tensors if hasattr(t, "mp_shard")]
        if shards:
            grid = shards[0].mp_shard.mesh
            _coalesced([t.data for t in shards],
                       lambda flat: dist.broadcast(flat, grid.mp_rank, group=grid.dp_group))


def gather_batch(x: Optional[torch.Tensor], dim: int = 0, group=None):
    """The global batch of `x`, this process's share of it along `dim`
    (every process holding as many rows): the shares of every process of
    `group`, concatenated in rank order. Only this process's rows carry
    autograd; the others' are constants. None stays None."""
    if x is None or not active():
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    parts[dist.get_rank(group)] = x
    return torch.cat(parts, dim)


def all_gather_rows(rows, group=None):
    """The host rows of every process of `group`, concatenated in rank
    order, where each process holds any number of them (none too): a numpy
    array, or a dict of them (a key that a process lacks counts as no rows
    there), through one `all_gather_object`."""
    if not active():
        return rows
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, rows, group=group)
    if not isinstance(rows, dict):
        return np.concatenate(parts)
    keys = dict.fromkeys(k for p in parts for k in p)  # first seen, in rank order
    return {k: np.concatenate([p[k] for p in parts if k in p]) for k in keys}


def process_seed(seed: int, rank: Optional[int] = None) -> int:
    """A seed of this process's own, drawn from `seed`: `seed` itself on
    rank 0 (and in one process), another on every other rank. Under a model
    axis give the dp rank: the mp processes of a dp row draw alike."""
    return seed + 1_000_003 * (rank_and_world()[0] if rank is None else rank)


def barrier(group=None) -> None:
    """Wait for every process of `group` (on NCCL, on this process's card)."""
    if active():
        if dist.get_backend(group) == "nccl":
            dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=group)


# ------------------------------------------------------------ the model axis


@dataclass
class Mesh:
    """The (dp, mp) mesh of this process: its rank on each axis and each
    axis's group (None in one process). Process r sits at (r // mp, r % mp):
    mp is the fastest-varying axis."""
    dp: int
    mp: int
    dp_rank: int
    mp_rank: int
    dp_group: object = None
    mp_group: object = None


def check_axes(world_size: int, mp: int) -> Optional[str]:
    """Why `world_size` processes cannot form a (dp, mp) mesh, or None."""
    if mp < 1 or mp > world_size or world_size % mp:
        return (f"--mp {mp}: {world_size} process(es) do not divide into dp x mp "
                f"(dp = processes // mp; one process a device, as the JAX package's "
                f"make_mesh asserts dp * mp <= devices)")
    return None


def make_mesh(mp: int = 1, device_type: str = "cpu") -> Mesh:
    """The (dp, mp) mesh over every process, dp = processes // mp. mp = 1 is
    the data axis alone over the default group (no new group); mp > 1
    builds both axes' groups (`init_device_mesh`). Raises where the
    processes do not divide by mp."""
    rank, world = rank_and_world()
    why = check_axes(world, mp)
    if why:
        raise ValueError(why)
    if mp == 1:
        return Mesh(world, 1, rank, 0, dist.group.WORLD if active() else None, None)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device_type, (world // mp, mp), mesh_dim_names=("dp", "mp"))
    return Mesh(world // mp, mp, dm.get_local_rank("dp"), dm.get_local_rank("mp"),
                dm.get_group("dp"), dm.get_group("mp"))


class Shard:
    """Which rows of a whole parameter this process holds: the tensor seen
    as `blocks` equal blocks along `dim` (the gates of an `nn.LSTM` weight:
    4), each block cut into mp parts along `dim`, part `mesh.mp_rank` of
    each block."""

    def __init__(self, mesh: Mesh, dim: int, blocks: int = 1):
        self.mesh, self.dim, self.blocks = mesh, dim, blocks

    def whole_shape(self, local_shape) -> tuple:
        shape = list(local_shape)
        shape[self.dim] *= self.mesh.mp
        return tuple(shape)

    def local(self, whole: torch.Tensor) -> torch.Tensor:
        """This process's rows of `whole`."""
        parts = [b.chunk(self.mesh.mp, self.dim)[self.mesh.mp_rank]
                 for b in whole.chunk(self.blocks, self.dim)]
        return torch.cat(parts, self.dim) if self.blocks > 1 else parts[0]

    def whole(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every mp process's rows (a collective over
        the mp group)."""
        local = local.contiguous()
        parts = [torch.empty_like(local) for _ in range(self.mesh.mp)]
        dist.all_gather(parts, local, group=self.mesh.mp_group)
        pieces = [p.chunk(self.blocks, self.dim) for p in parts]
        return torch.cat([pieces[r][b] for b in range(self.blocks)
                          for r in range(self.mesh.mp)], self.dim)


class _Gather(torch.autograd.Function):
    """The whole weight from the shards; its gradient's rows of this shard
    (every mp process computes the same whole gradient: same rows, same
    weights, same draws)."""

    @staticmethod
    def forward(ctx, local, shard):
        ctx.shard = shard
        return shard.whole(local)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.local(grad).contiguous(), None


class GatherShard(nn.Module):
    """The parametrization of a sharded parameter: the whole weight."""

    def __init__(self, shard: Shard):
        super().__init__()
        self.shard = shard

    def forward(self, local):
        return _Gather.apply(local, self.shard)


def param_placement(model: nn.Module, mp: int, min_size: int = MP_MIN_SIZE) -> Dict[str, tuple]:
    """Parameter name -> (torch dim, blocks) for each parameter the JAX
    rule shards over `mp` (`uvhand_tpu/train/mesh.py::param_sharding_for_path`
    on its JAX leaves, `convert.leaf_layouts`): every leaf 2-D, at least
    `min_size` elements, its output axis divisible by mp, not under
    `backbone`. The others are absent (replicated)."""
    from .convert import leaf_layouts

    if mp <= 1:
        return {}
    out = {}
    for name, layout in leaf_layouts(model).items():
        if layout is not None and not layout.backbone and layout.size >= min_size \
                and layout.out % mp == 0:
            out[name] = (layout.dim, layout.blocks)
    return out


def _owners(model: nn.Module):
    """(module, attribute name, parameter name) of every parameter, once."""
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            yield mod, pname, f"{mname}.{pname}" if mname else pname


@torch.no_grad()
def shard_params(mesh: Mesh, model: nn.Module, min_size: int = MP_MIN_SIZE) -> Dict[str, Shard]:
    """Shard `model`'s parameters by the JAX rule over `mesh.mp`
    (`param_placement`): each keeps 1/mp of its rows, in place (the same
    Parameter object, so an optimizer made before keeps it), and is read
    whole through a `GatherShard` parametrization. Returns the shards by
    parameter name."""
    placed = param_placement(model, mesh.mp, min_size)
    shards = {}
    for mod, pname, name in list(_owners(model)):
        if name not in placed:
            continue
        shard = Shard(mesh, *placed[name])
        parametrize.register_parametrization(mod, pname, GatherShard(shard), unsafe=True)
        original = mod.parametrizations[pname].original
        original.data = shard.local(original.data).contiguous()
        original.mp_shard = shards[name] = shard
    return shards


@torch.no_grad()
def shard_state(mesh: Mesh, model: nn.Module, optimizer: torch.optim.Optimizer,
                min_size: int = MP_MIN_SIZE) -> Dict[str, Shard]:
    """`shard_params`, then the optimizer's state shards like its
    parameters: the moments (and a stochastic-rounding optimizer's float32
    copies) of a sharded parameter keep its rows."""
    shards = shard_params(mesh, model, min_size)
    copies = [p for g in optimizer.param_groups for p in g["params"]]
    owners = getattr(optimizer, "bf16_params", copies)
    for p, q in zip(owners, copies):
        shard = getattr(p, "mp_shard", None)
        if shard is None:
            continue
        if q is not p:
            q.data = shard.local(q.data).contiguous()
            q.mp_shard = shard
        for k, v in optimizer.state.get(q, {}).items():
            if torch.is_tensor(v) and v.dim() > 0:
                optimizer.state[q][k] = shard.local(v).contiguous()
    return shards


_PARAMETRIZED = re.compile(r"(^|\.)parametrizations\.([^.]+)\.original$")


def whole_name(key: str) -> str:
    """A sharded parameter's state-dict key as the whole model names it."""
    return _PARAMETRIZED.sub(r"\1\2", key)


def is_sharded(model: nn.Module) -> bool:
    return any(hasattr(p, "mp_shard") for p in model.parameters())


def whole_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict as one process holds it: the reference's
    names, every sharded parameter gathered whole (a collective over the
    mp group on every process of it)."""
    if not is_sharded(model):
        return model.state_dict()
    out = {}
    for k, v in model.state_dict(keep_vars=True).items():
        shard = getattr(v, "mp_shard", None)
        out[whole_name(k)] = (v if shard is None else shard.whole(v)).detach()
    return out


@torch.no_grad()
def load_whole_state_dict(model: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy whole tensors (the reference's names) into the model, each
    sharded parameter its rows; names `state` lacks keep their values."""
    for k, v in model.state_dict(keep_vars=True).items():
        name = whole_name(k)
        if name in state:
            shard = getattr(v, "mp_shard", None)
            v.copy_(state[name] if shard is None else shard.local(state[name]))


def _optimizer_params(optimizer):
    return [p for g in optimizer.param_groups for p in g["params"]]


def whole_optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    """`optimizer.state_dict()` with each sharded parameter's state
    gathered whole (a collective over the mp group)."""
    sd = optimizer.state_dict()
    params = _optimizer_params(optimizer)
    if not any(hasattr(p, "mp_shard") for p in params):
        return sd
    state = {}
    for i, st in sd["state"].items():
        shard = getattr(params[i], "mp_shard", None)
        state[i] = {k: shard.whole(v) if shard is not None and torch.is_tensor(v) and v.dim() > 0
                    else v for k, v in st.items()}
    return {**sd, "state": state}


def local_optimizer_state(optimizer: torch.optim.Optimizer, saved: dict) -> dict:
    """A whole optimizer state dict (`whole_optimizer_state`'s, or one
    process's) with each sharded parameter's state cut to its rows."""
    params = _optimizer_params(optimizer)
    if not saved or not any(hasattr(p, "mp_shard") for p in params):
        return saved
    state = {}
    for i, st in saved.get("state", {}).items():
        shard = getattr(params[i], "mp_shard", None) if i < len(params) else None
        state[i] = {k: shard.local(v).contiguous() if shard is not None and torch.is_tensor(v)
                    and v.dim() > 0 else v for k, v in st.items()}
    return {**saved, "state": state}
