"""Multi-process initialization through torch.distributed.

Port of `uvhand_tpu/train/launch.py` (the reference's `init_distributed_mode`,
`util/misc.py:519-559`, and its launchers): one call to
`torch.distributed.init_process_group` with explicit, env or SLURM
discovery. A launch of N processes is `torchrun --nproc_per_node N -m
uvhand_tpu_torch.cli.main ...` (it sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT) or `srun` (SLURM_PROCID, SLURM_NTASKS,
SLURM_LOCALID, SLURM_STEP_NODELIST). Each process drives one device:
NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import builtins
import datetime
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

#: seconds a collective may wait before it fails (a hung peer must end the
#: run, not hold it)
TIMEOUT_S = 600.0


def local_rank(rank: int = 0) -> int:
    """This process's device index on its node: LOCAL_RANK, else
    SLURM_LOCALID, else `rank` modulo the node's CUDA devices."""
    for key in ("LOCAL_RANK", "SLURM_LOCALID"):
        if key in os.environ:
            return int(os.environ[key])
    return rank % max(torch.cuda.device_count(), 1)


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, backend: str | None = None,
                   timeout_s: float = TIMEOUT_S, device=None) -> dict:
    """Join (or create) the default process group. Returns the topology:
    {"process_index", "process_count", "local_devices", "global_devices"}.

    Resolution order (the JAX package's, `util/misc.py:519-559`):
      1. explicit arguments (`coordinator` "host:port");
      2. env MASTER_ADDR (MASTER_PORT, default 1234), WORLD_SIZE, RANK;
      3. SLURM_PROCID / SLURM_NTASKS and the first node of
         SLURM_STEP_NODELIST, port 29500;
      4. none of them: a single process, and no process group.
    The backend is NCCL where the process's `device` is CUDA (the default;
    its index is `local_rank`) and gloo where it is the CPU, unless
    `backend` names one. Every collective of the group fails after
    `timeout_s` seconds."""
    init_method = None if coordinator is None else f"tcp://{coordinator}"
    if coordinator is None and "MASTER_ADDR" in os.environ:
        # env:// reads MASTER_ADDR/MASTER_PORT and, under torchrun, joins the
        # store its agent already serves there
        os.environ.setdefault("MASTER_PORT", "1234")
        init_method = "env://"
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
        process_id = int(os.environ.get("RANK", 0))
    elif coordinator is None and "SLURM_PROCID" in os.environ:
        node = os.environ["SLURM_STEP_NODELIST"].split(",")[0].replace("[", "")
        init_method = f"tcp://{node}:29500"
        num_processes = int(os.environ["SLURM_NTASKS"])
        process_id = int(os.environ["SLURM_PROCID"])

    if init_method is not None and not dist.is_initialized():
        rank, world = int(process_id or 0), int(num_processes or 1)
        if backend is None:
            backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(local_rank(rank))
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    return {"process_index": rank, "process_count": world, "local_devices": 1,
            "global_devices": world}


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def print_on_main_only() -> None:
    """Make `print` a no-op on every process but rank 0 (`print(...,
    force=True)` still prints), as the reference's `setup_for_distributed`
    does; a CLI calls it once after `init_multihost`."""
    if is_main_process():
        return
    plain = builtins.print

    def print_(*args, force: bool = False, **kwargs):
        if force:
            plain(*args, **kwargs)

    builtins.print = print_
