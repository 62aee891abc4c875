"""Host-to-device batch prefetch for the training loops, PyTorch port of
the JAX package's `engine/prefetch.py`.

`prefetch_to_device` keeps `size` batches in flight: each host batch is
copied into pinned memory and sent to the card with `non_blocking=True` on
a side stream, so batch i+1's upload rides under step i's compute. The
consumer's stream waits on the upload's event before it reads a batch, and
each tensor is `record_stream`ed on it, so that the caching allocator does
not hand its memory out again before the consumer is done with it.

Opt-in, as in JAX: the trainers' loops feed synchronously;
`chip_smoke.py` measures both feeds.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Iterable, Iterator

import numpy as np
import torch


def _upload(batch: Dict[str, Any], device: torch.device,
            stream) -> Dict[str, torch.Tensor]:
    if stream is None:
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    with torch.cuda.stream(stream):
        return {k: torch.as_tensor(np.ascontiguousarray(v)).pin_memory().to(
                    device, non_blocking=True)
                for k, v in batch.items()}


def prefetch_to_device(iterator: Iterable[Dict[str, Any]], device,
                       size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the dict batches of `iterator` (numpy arrays or CPU tensors)
    as tensors on `device`, `size` batches ahead (2 = double buffering).
    On a CUDA device the copies run on a side stream; elsewhere they are
    plain copies."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    device = torch.device(device)
    return _prefetch(iterator, device, size)


def _prefetch(iterator, device: torch.device, size: int):
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    buf: collections.deque = collections.deque()

    def ready(item):
        tensors, event = item
        if cuda:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            for t in tensors.values():
                t.record_stream(consumer)
        return tensors

    for batch in iterator:
        tensors = _upload(batch, device, stream)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(stream)
        buf.append((tensors, event))
        if len(buf) >= size:
            yield ready(buf.popleft())
    while buf:
        yield ready(buf.popleft())
