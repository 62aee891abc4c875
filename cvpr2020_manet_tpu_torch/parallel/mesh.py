"""Device mesh and sharding helpers, PyTorch port of `parallel/mesh.py`.

The JAX package lays its devices out as a 2-D `jax.sharding.Mesh` with the
axes

  'data'    — batch sharding (training);
  'context' — reference-pixel sharding for global matching: each member
              matches its shard of the memory rows and the members'
              results are combined by a min (`parallel/cp_matching.py`).

The port keeps that layout in a single-controller form: one process holds
a `Mesh`, a (data, context) array of **member devices** (`torch.device`s),
and drives every member itself. A caller may name the same device more
than once: several members then share one card, each with its own
streams (`parallel/ring.py`), and the copies between them are
device-local instead of peer copies. CPU members (`torch.device("cpu")`)
run the same schedules in order; the tests use them.

The 'data' axis replicates the context-parallel computation, as in JAX:
every data row would compute the same result, so the port computes the
ring of data row 0 only (`Mesh.context_devices`) and hands the result to
the caller's device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

AXIS_NAMES = ("data", "context")


class Mesh:
    """A (data, context) array of member devices."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D device array, got "
                             f"shape {devices.shape}")
        self.devices = devices
        self.axis_names = AXIS_NAMES

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def context_devices(self) -> list[torch.device]:
        """The context ring's members: data row 0 (the data axis
        replicates)."""
        return list(self.devices[0])


def create_mesh(data: int = -1, context: int = 1,
                devices: Sequence[str | torch.device] | None = None) -> Mesh:
    """Build a ('data', 'context') mesh over `devices` (default: every
    visible card, cuda:0 .. cuda:n-1; raises without CUDA). data=-1 takes
    every device left over after `context`. A list may repeat a device:
    its members then share that card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices= (for example "
                "[torch.device('cpu')] * 4) to build a mesh of CPU members")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if context < 1:
        raise ValueError(f"context={context}: at least 1")
    if data == -1:
        if n % context:
            raise ValueError(f"{n} devices do not split into context "
                             f"groups of {context}")
        data = n // context
    if data < 1 or data * context > n:
        raise ValueError(f"a {data} x {context} mesh needs {data * context} "
                         f"devices, {n} given")
    grid = np.empty((data, context), dtype=object)
    for i, d in enumerate(devices[:data * context]):
        grid[i // context, i % context] = d
    return Mesh(grid)


def shard_context(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Shard axis 0 (reference pixels) over the context ring (JAX's
    P("context")): contiguous chunks, chunk i on member i. The row count
    must divide by the member count, as in JAX."""
    devices = mesh.context_devices
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} members")
    return [c.to(d) for c, d in zip(x.chunk(n), devices)]
