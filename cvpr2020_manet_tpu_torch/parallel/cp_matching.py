"""Context-parallel global matching, PyTorch port of
`parallel/cp_matching.py`.

The memory rows shard over the mesh's 'context' members (contiguous
chunks, `parallel/mesh.py`); the query is replicated. Three schedules give
the same (Nq, O) normalized distances as global matching over all rows:

- `allgather` (`local_then_min`): each member matches its shard with the
  engine's global-matching backend (kernel 1 on a card), and the members'
  results meet on the caller's device for a min. The engines use this one
  (`cp_match_flat`), as in JAX.
- `ring` (`ring_local_then_min`): the shards rotate around the ring
  (`parallel/ring.py`) and each member folds a normalized kernel-1 pass
  per step into a running min that starts at 1.0.
- `ring_kernel` (JAX's `ring_pallas`): each member buckets its own shard
  (`prepare_ref`, keys in f32), the bucketed shards rotate, and kernel 6
  (`ops/ring_matching_cuda.py`) folds an un-normalized running min per
  step, normalizing at the last one. The onehot is gated by `valid` first.

The min combine is exact on normalized distances: the normalization is
monotone, so min-of-normalized equals normalize-of-min.

Training (`trainable_local_then_min`, the cp train step's): each member
matches its share of the rows through `GlobalMatchingTrainable` (kernel 4
on a card, the plain version on the CPU; JAX backs its shards with the
jnp oracle), and the members' maps meet in a differentiable min on the
query's device, so the gradient reaches each key through the member that
won.

Every member computes the whole result; data row 0 of the mesh runs it
(the data axis replicates) and the result goes to the query's device.
The int8 backend has no context-parallel fold: an engine with a `cp_mesh`
refuses it (`check_cp_engine`), as in JAX.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
    _round_up, global_matching_prepared, prepare_ref)
from cvpr2020_manet_tpu_torch.ops.ring_matching_cuda import (
    RingShard, ring_matching_step)
from cvpr2020_manet_tpu_torch.ops.trainable import GlobalMatchingTrainable
from cvpr2020_manet_tpu_torch.parallel.mesh import Mesh, shard_context
from cvpr2020_manet_tpu_torch.parallel.ring import ring_rotate

SCHEDULES = ("allgather", "ring", "ring_kernel")


def check_cp_engine(mesh: Mesh, device: torch.device,
                    matching_backend: str, engine: str) -> None:
    """What an engine on `device` whose model matches with
    `matching_backend` needs of its `cp_mesh`: the default backend (the
    int8 backend has no context-parallel fold and raises, as in the JAX
    engines) and members of the engine's device type (members on the CPU
    would run a card engine's matching through the plain version)."""
    if matching_backend == "int8":
        raise ValueError(
            f"matching_backend 'int8' does not compose with context-parallel "
            f"{engine} (cp_mesh); use the default backend")
    kinds = {torch.device(d).type for d in mesh.devices.flat}
    if kinds != {device.type}:
        raise ValueError(
            f"cp_mesh members on {sorted(kinds)} for a {engine} engine on "
            f"{device.type}; the members must be {device.type} devices")


def _shard_matching(query, ref, onehot, valid) -> torch.Tensor:
    """One shard's normalized (Nq, O) distances on the default backend:
    query and keys meet in their promoted type, as in the model."""
    dt = torch.promote_types(query.dtype, ref.dtype)
    return global_matching_prepared(query.to(dt),
                                    prepare_ref(ref.to(dt), onehot, valid))


def local_then_min(query, ref_shards, onehot_shards, valid_shards,
                   devices: Sequence[torch.device]) -> torch.Tensor:
    """Per-shard matching on each member, then a min over the gathered
    (Nq, O) results on the query's device."""
    outs = []
    for d, ref, oh, valid in zip(devices, ref_shards, onehot_shards,
                                 valid_shards):
        outs.append(_shard_matching(query.to(d), ref, oh, valid)
                    .to(query.device))
    return torch.stack(outs).amin(dim=0)


def trainable_local_then_min(query: torch.Tensor, ref: torch.Tensor,
                             ref_gate: torch.Tensor,
                             devices: Sequence[torch.device]) -> torch.Tensor:
    """Differentiable `local_then_min` for training: query (Nq, C), ref
    (Nk, C) and ref_gate (Nk, O) (the one-hot times its validity) on the
    caller's device; member m of `devices` matches rows [m Nk/n, (m + 1)
    Nk/n) through `GlobalMatchingTrainable`, and the (Nq, O) maps meet in
    `stack(...).amin(0)` on the query's device. Nk must divide by the
    member count (JAX's step drops the tail rows; the port raises)."""
    n, nk = len(devices), ref.shape[0]
    if nk % n:
        raise ValueError(f"{nk} reference rows do not split over {n} "
                         f"context members")
    outs = [GlobalMatchingTrainable.apply(query.to(d), k.to(d), g.to(d))
            .to(query.device)
            for d, k, g in zip(devices, ref.chunk(n), ref_gate.chunk(n))]
    return torch.stack(outs).amin(0)


def ring_local_then_min(query, ref_shards, onehot_shards, valid_shards,
                        devices: Sequence[torch.device]) -> torch.Tensor:
    """The shards (rows, onehot, valid) rotate around the ring while each
    member folds its per-step matching into a running min (normalized
    space: an empty object stays at 1.0)."""
    o = onehot_shards[0].shape[1]
    queries = [query.to(d) for d in devices]
    dmin = [torch.ones((query.shape[0], o), dtype=torch.float32, device=d)
            for d in devices]

    def step(m, s, arrays):
        torch.minimum(dmin[m], _shard_matching(queries[m], *arrays),
                      out=dmin[m])

    ring_rotate(devices, list(zip(ref_shards, onehot_shards, valid_shards)),
                step)
    return dmin[0].to(query.device)


def ring_kernel(query, ref_shards, onehot_shards, valid_shards,
                devices: Sequence[torch.device],
                step_fn=ring_matching_step) -> torch.Tensor:
    """JAX's `ring_pallas`: the bucketed f32 shards rotate around the ring
    and kernel 6 folds them step by step into an un-normalized running
    min, normalized at the last step. A bf16 query is promoted to f32, the
    keys' type. `step_fn`: the per-step fold (kernel 6's wrapper; its
    plain version drives the plain ring on a card)."""
    n = len(devices)
    nq, c = query.shape
    o = onehot_shards[0].shape[1]
    c_pad = _round_up(c, 128)
    shards, queries, accs, outs = [], [], [], []
    for d, ref, oh, valid in zip(devices, ref_shards, onehot_shards,
                                 valid_shards):
        gated = oh * valid.to(oh.dtype)[:, None]
        b = prepare_ref(ref.float(), gated)
        shards.append((b.neg2pixels, b.sqnorm, b.block_obj))
        queries.append(F.pad(query.to(d, torch.float32),
                             (0, c_pad - c)).contiguous())
        accs.append(torch.empty((nq, o), dtype=torch.float32, device=d))
        outs.append(torch.empty((nq, o), dtype=torch.float32, device=d))

    def step(m, s, arrays):
        step_fn(queries[m], RingShard(*arrays), accs[m], outs[m],
                first=s == 0, last=s == n - 1)

    ring_rotate(devices, shards, step)
    return outs[0].to(query.device)


def context_parallel_matching(query: torch.Tensor, ref: torch.Tensor,
                              ref_onehot: torch.Tensor,
                              ref_valid: torch.Tensor, mesh: Mesh,
                              schedule: str = "allgather") -> torch.Tensor:
    """Global matching of query (Nq, C) against ref (Nk, C), ref_onehot
    (Nk, O), ref_valid (Nk,), with the rows sharded over the mesh's
    context members (Nk must divide by their count). -> (Nq, O) f32
    normalized distances on the query's device."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule={schedule!r}: one of {SCHEDULES}")
    impl = {"allgather": local_then_min, "ring": ring_local_then_min,
            "ring_kernel": ring_kernel}[schedule]
    shards = [shard_context(x, mesh) for x in (ref, ref_onehot, ref_valid)]
    return impl(query, *shards, mesh.context_devices)


def cp_match_flat(query_flat: torch.Tensor, ref: torch.Tensor,
                  ref_onehot: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The engines' call: flattened queries against a reference whose
    validity is already folded into `ref_onehot` (allgather schedule, as
    in JAX). -> (Nq, O); callers reshape to their grid."""
    valid = torch.ones((ref.shape[0],), dtype=torch.float32,
                       device=ref.device)
    return context_parallel_matching(query_flat, ref, ref_onehot, valid,
                                     mesh)
