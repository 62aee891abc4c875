"""Tracing / profiling hooks, PyTorch port of the JAX package's
`utils/profiling.py`.

- `trace(log_dir)`: context manager around `torch.profiler.profile`; on
  exit it writes a Chrome trace (`trace.json`, viewable in Perfetto or
  chrome://tracing) into `log_dir`. It records the CPU, and the card's
  kernels too where CUDA is available.
- `annotate(name)`: the program's one span call. While the calling
  thread's profiler runs it is a `torch.profiler.record_function` range,
  which the profiler stamps on the same clock as the card's kernels;
  otherwise it is one shared no-op context, at the cost of a flag read.
  The profiler's state is thread-local: a span opened on another thread
  (the download pool's) is never recorded.
- `elapsed_ms(fn, n, device)`, `slope_ms(fn, iters, reps, device)`: the
  device time of back-to-back calls, and its marginal time a call with
  the fixed host costs cancelled (the measuring entry points'
  `bench_matching_kernel.py`, `profile_stages.py`, `profile_encode.py`).

`profile_round.py` and `profile_train.py` keep their own trace code,
which also sums device time by kernel class; `profile_round.py` reads the
`manet.*` spans of `annotate`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; write `<log_dir>/trace.json` on exit."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


# what `annotate` returns while no profiler runs on the calling thread: a
# `record_function` costs about 10 us a call even then, the flag read 0.1
NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A span named `name`, recorded while the calling thread's profiler
    runs (`with annotate("manet.round"): ...`)."""
    if not torch._C._autograd._profiler_enabled():
        return NO_SPAN
    return record_function(name)


def elapsed_ms(fn: Callable[[], object], n: int, device: torch.device
               ) -> float:
    """Milliseconds of `n` back-to-back calls of `fn`, up to the end of the
    work they queue: CUDA events around them on the card (the host queues
    the calls ahead of it), the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3


def slope_ms(fn: Callable[[], object], iters: int, reps: int,
             device: torch.device) -> tuple[float, float]:
    """Two-point slope timing, the JAX package's profilers' method: the best
    of `reps` runs of `iters` and of `2 iters` calls; their difference over
    `iters` is the marginal time a call, in which the fixed costs of a run
    (the first launch's latency, the final wait) cancel. -> (ms a call,
    fixed ms of a run). Warm `fn` up first: its first call may build or
    load a kernel."""
    best_lo = best_hi = float("inf")
    for _ in range(reps):
        best_lo = min(best_lo, elapsed_ms(fn, iters, device))
        best_hi = min(best_hi, elapsed_ms(fn, 2 * iters, device))
    ms = max((best_hi - best_lo) / iters, 1e-9)
    return ms, max(best_lo - iters * ms, 0.0)
