"""Multi-process execution layer, PyTorch port of `parallel/distributed.py`.

One process (rank) per card, as `torch.distributed` runs data-parallel
training; the JAX package runs one SPMD program over every host's chips.
Three pieces, each a no-op in the single-process case so that the same
CLI flags work on one card:

  1. `initialize()` joins a `torch.distributed` process group through
     `tcp://<coordinator>`. Arguments resolve as in JAX: explicit ones,
     then the MANET_COORDINATOR / MANET_NUM_PROCESSES / MANET_PROCESS_ID
     environment variables, then a single process. It refuses the
     single-process fallback when the environment says this process is
     one of several (WORLD_SIZE or MANET_NUM_PROCESSES above 1) but no
     group can be joined: N processes each believing they are rank 0 of 1
     would train N independent jobs and overwrite each other's snapshots.
  2. The global-batch contract: `config.train.batch_size` is the GLOBAL
     batch; each rank feeds `local_batch_size()` samples a step.
  3. There is no `shard_host_batch`: JAX assembles the ranks' local
     batches into one global array (`make_array_from_process_local_data`)
     for one program; here each rank runs its own local batch, and the
     trainers' all-reduce of the gradients and the metrics (divided by the
     world size) gives the global batch's mean, as JAX's step does.

The backend is `nccl` for a CUDA rank and `gloo` for a CPU rank unless the
caller names one; it is never switched on the caller's behalf. Rank r
uses `cuda:(r % torch.cuda.device_count())`.
"""

from __future__ import annotations

import os
import socket
import sys

import torch
import torch.distributed as dist

from cvpr2020_manet_tpu_torch.device import resolve_device


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def _multi_process_markers() -> list[str]:
    """Environment evidence that this process is one of several."""
    return [f"{k}={os.environ[k]}" for k in ("WORLD_SIZE",
                                             "MANET_NUM_PROCESSES")
            if (_env_int(k) or 1) > 1]


def free_port() -> int:
    """A free localhost TCP port (it may be taken again before it is bound:
    callers retry on "address already in use")."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None,
               device=None) -> tuple[int, int]:
    """Join the process group; -> (rank, world size).

    coordinator: "host:port" of rank 0's store. A group of one process may
    leave it out (a free localhost port is taken). device: the rank's
    device type, `cuda` unless the caller passes "cpu" (a CUDA rank takes
    card rank % device_count as its current device). backend: default
    `nccl` on CUDA, `gloo` on the CPU. Calling it again in a process that
    has joined returns the group's (rank, world size)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator = coordinator or os.environ.get("MANET_COORDINATOR") or None
    if num_processes is None:
        num_processes = _env_int("MANET_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("MANET_PROCESS_ID")

    if coordinator is None and num_processes is None:
        markers = _multi_process_markers()
        if markers:
            raise RuntimeError(
                f"the environment says this process is one of several "
                f"({', '.join(markers)}), but no coordinator or process "
                f"count was given; refusing the single-process fallback: N "
                f"processes each believing they are rank 0 of 1 would train "
                f"N independent jobs and overwrite each other's snapshots")
        print("distributed.initialize: no cluster given; single-process "
              "mode", file=sys.stderr)
        return 0, 1
    world = 1 if num_processes is None else num_processes
    if coordinator is None:
        if world > 1:
            raise RuntimeError(
                f"{world} processes need a coordinator (--coordinator or "
                f"MANET_COORDINATOR, host:port of rank 0)")
        coordinator = f"127.0.0.1:{free_port()}"
    if process_id is None:
        if world > 1:
            raise RuntimeError(
                f"rank of this process unknown: pass --process_id or set "
                f"MANET_PROCESS_ID (0..{world - 1})")
        process_id = 0
    if not 0 <= process_id < world:
        raise ValueError(f"process_id {process_id} outside 0..{world - 1}")
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev         # the rank's card, bound at once
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            rank=process_id, world_size=world, **kw)
    return dist.get_rank(), dist.get_world_size()


def process_group():
    """The world group once `initialize` has joined one, else None."""
    return dist.group.WORLD if dist.is_initialized() else None


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_batch_size(global_batch: int) -> int:
    """Per-rank feed size under the global-batch contract."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"process count {n}")
    return global_batch // n


def all_reduce_mean_(tensors, group) -> None:
    """Replace each tensor by its mean over the group's ranks: one
    all-reduce of one flat f32 buffer, not one call per tensor."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for t, f in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(f.view_as(t))


def barrier() -> None:
    """Wait for every rank (a no-op in one process)."""
    if dist.is_initialized():
        dist.barrier()
