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


def tool_device(cpu: bool) -> tuple[torch.device, str]:
    """The device of a measuring entry point and the name its figures
    carry: the CPU with `--cpu` (the kernels' plain versions), else the
    card, as `resolve_device` gives it (raises without CUDA)."""
    if cpu:
        return torch.device("cpu"), "cpu"
    dev = resolve_device(None)
    return dev, torch.cuda.get_device_name(dev)


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on `device` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: str | torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (the kernels' launch
    planners fill them)."""
    return _sm_count(torch.device(device).index or 0)
