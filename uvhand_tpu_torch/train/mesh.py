"""The data axis over processes: collectives on the default process group.

Port of the data-parallel half of `uvhand_tpu/train/mesh.py`. The JAX
package shards the global batch over a mesh axis and computes one loss over
it in one program; here each process holds a contiguous share of the
global batch's rows (`rank_slice`), and the train step gathers the outputs
that the criterion reads (`gather_batch`), so that every process computes
the loss of the global batch, then sums the gradients (`all_reduce_grads`).
Every helper is a no-op where no process group exists.

Not ported: the model axis (`--mp`, the JAX package's `param_sharding` /
`shard_params`, ROADMAP Queue 1 item 6b).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

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


@torch.no_grad()
def broadcast_params(model: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `model` from process `src`."""
    if active():
        tensors = list(model.parameters()) + list(model.buffers())
        _coalesced([t.data for t in tensors], lambda flat: dist.broadcast(flat, src))


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


def process_seed(seed: int) -> int:
    """A seed of this process's own, drawn from `seed`: `seed` itself on
    rank 0 (and in one process), another on every other rank."""
    return seed + 1_000_003 * rank_and_world()[0]


def barrier(group=None) -> None:
    """Wait for every process of `group` (on NCCL, on this process's card)."""
    if active():
        if dist.get_backend(group) == "nccl":
            dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=group)
