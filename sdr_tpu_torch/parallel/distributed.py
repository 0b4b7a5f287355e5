"""Multi-process execution helpers, on torch.distributed.

Port of sdr_tpu/parallel/distributed.py.  Each process feeds its own
shard of RF channels (SURVEY §5.8): it reads or synthesizes only its
channels' u8 streams and runs them on its own devices.  As in the
reference, whose shard body holds no collective, nothing crosses
processes but the rendezvous: `initialize` joins the process group, and
every later call is local.  Initialization is explicit, so importing
this module needs no cluster.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from sdr_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None) -> None:
    """Join the process group (a no-op for one process).

    coordinator_address: "host:port" (or a tcp:// URL) of the rendezvous;
      None reads torch's env:// variables (MASTER_ADDR, WORLD_SIZE, RANK).
    backend: "gloo" or "nccl"; by default NCCL where CUDA is available,
      gloo where the tensors stay on the CPU.  Processes that share one
      card rendezvous over gloo (NCCL takes one card a process).
    """
    if num_processes is not None and num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = "env://"
    if coordinator_address is not None:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=init,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def _process() -> tuple[int, int]:
    """(this process's index, the process count)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_channel_mesh(axis: str = "channels",
                        devices: list | None = None) -> Mesh:
    """The mesh of the whole job, as this process holds it: its own
    devices (default every CUDA device here, as make_mesh), one shard
    each, beside the other processes' shards."""
    rank, world = _process()
    local = make_mesh(axis=axis, devices=devices)
    return dataclasses.replace(local, process_index=rank,
                               process_count=world)


def local_channel_slice(n_channels: int) -> tuple[int, int]:
    """[start, stop) of the channel range this process feeds."""
    rank, world = _process()
    if n_channels % world:
        raise ValueError(f"{n_channels} channels not divisible across "
                         f"{world} processes")
    per = n_channels // world
    return rank * per, (rank + 1) * per


@dataclasses.dataclass(frozen=True)
class GlobalBatch:
    """This process's rows of a (channels, n) batch across processes:
    `local` holds global rows [offset, offset + len(local)) of n_global."""
    local: np.ndarray | torch.Tensor
    offset: int
    n_global: int


def make_global_batch(local_u8, mesh: Mesh,
                      axis: str = "channels") -> GlobalBatch:
    """The batch across processes from each process's locally fed rows
    (every process feeds as many); `channels.sharded_run` runs its local
    rows and returns their outputs."""
    n_local = local_u8.shape[0]
    if n_local % len(mesh.devices):
        raise ValueError(f"{n_local} local channels not divisible by "
                         f"{len(mesh.devices)} local shards on {axis!r}")
    return GlobalBatch(local_u8, mesh.process_index * n_local,
                       n_local * mesh.process_count)
