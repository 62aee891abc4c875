"""Device selection shared by the port's entry points."""

from __future__ import annotations

import functools

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent —
    the port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: str | torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (the kernels' launch
    planners fill them)."""
    return _sm_count(torch.device(device).index or 0)
