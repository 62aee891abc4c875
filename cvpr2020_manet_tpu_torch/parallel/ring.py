"""Rotation of per-member buffers around a context ring.

The counterpart of `lax.ppermute(perm=[(i, i + 1)])` in a loop, and of the
slot handshake of the TPU ring kernel (`ops/ring_matching_pallas.py`
`_ring_kernel`, its recv / ready semaphores). `ring_rotate` runs an n-step
ring over n members: at step s member m works on the shard that started
on member (m - s) mod n, so that every member sees every shard once.

Each member has two slots per rotating array and, on a card, a compute
stream and a copy stream of its own. At step s a member reads slot s % 2
(its own shard at step 0). The copy of that slot into the right
neighbour's slot (s + 1) % 2 runs on the neighbour's copy stream and
overlaps step s's compute. The copy waits on two events:

- "the neighbour finished step s - 1", which read the destination slot;
- "this member's slot s % 2 has arrived".

A member's step s counts as finished only once its outgoing copy has
drained (the TPU kernel waits on its send at the end of a step before it
signals its left neighbour), and step s + 1's compute waits on its own
slot's arrival. A plain barrier between neighbours is not enough on rings
of 3 or more members: a fast member could slide a full step ahead and
overwrite a slot still being read; the per-slot events rule that out.

`Tensor.copy_(non_blocking=True)` is a peer copy between distinct cards
and a device-local copy when members share a card. CPU members run the
same schedule in order, synchronously. The caller's current streams are
ordered before the ring's first step and after its last.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def _event(stream) -> torch.cuda.Event:
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def ring_rotate(devices: Sequence[torch.device],
                shards: Sequence[tuple[torch.Tensor, ...]],
                step: Callable[[int, int, tuple[torch.Tensor, ...]], None]
                ) -> None:
    """Run the n-step ring. shards[m]: member m's own rotating arrays, on
    devices[m], with the same shapes and types on every member (they are
    read, never written). step(m, s, arrays) enqueues member m's work of
    step s on `arrays`; on a card it runs with m's compute stream
    current, and whatever it writes must have been allocated before the
    ring (on the caller's stream)."""
    n = len(devices)
    if len(shards) != n:
        raise ValueError(f"{len(shards)} shards for {n} members")
    devices = [torch.device(d) for d in devices]
    on_cuda = devices[0].type == "cuda"
    if any((d.type == "cuda") != on_cuda for d in devices):
        raise ValueError("a ring's members are all CUDA or all CPU devices")
    # two slots per member and rotating array; step 0 reads the own shard
    bufs = [[tuple(torch.empty_like(a) for a in shards[m]) for _ in range(2)]
            for m in range(n)] if n > 1 else []

    def slot(m: int, s: int):
        return shards[m] if s == 0 else bufs[m][s % 2]

    def copy(dst, src):
        for d, a in zip(dst, src):
            d.copy_(a, non_blocking=on_cuda)

    if not on_cuda:
        for s in range(n):
            for m in range(n):
                if s < n - 1:
                    copy(bufs[(m + 1) % n][(s + 1) % 2], slot(m, s))
                step(m, s, slot(m, s))
        return

    # PyTorch hands streams out of a per-device pool, round robin: the
    # members of one card get streams of their own
    streams = [(torch.cuda.Stream(d), torch.cuda.Stream(d)) for d in devices]
    callers = [torch.cuda.current_stream(d) for d in devices]
    arrived = [[None] * n for _ in range(n)]     # [member][step]
    done = [[None] * n for _ in range(n)]
    for m in range(n):
        arrived[m][0] = _event(callers[m])       # own shard, as enqueued
    for s in range(n):
        for m in range(n):
            r = (m + 1) % n
            if s < n - 1:
                recv = streams[r][1]
                recv.wait_event(arrived[m][s])
                if s >= 1:
                    recv.wait_event(done[r][s - 1])
                # between distinct cards PyTorch runs a peer copy on the
                # source device's current stream, fenced with the
                # destination's: make those m's and r's copy streams
                with torch.cuda.stream(streams[m][1]), \
                        torch.cuda.stream(recv):
                    copy(bufs[r][(s + 1) % 2], slot(m, s))
                arrived[r][s + 1] = _event(recv)
            compute = streams[m][0]
            compute.wait_event(arrived[m][s])
            with torch.cuda.device(devices[m]), torch.cuda.stream(compute):
                step(m, s, slot(m, s))
            if s < n - 1:
                compute.wait_event(arrived[r][s + 1])   # the send drained
            done[m][s] = _event(compute)
    for m in range(n):
        callers[m].wait_event(done[m][n - 1])
