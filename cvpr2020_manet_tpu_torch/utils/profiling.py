"""Tracing / profiling hooks, PyTorch port of the JAX package's
`utils/profiling.py`.

- `trace(log_dir)`: context manager around `torch.profiler.profile`; on
  exit it writes a Chrome trace (`trace.json`, viewable in Perfetto or
  chrome://tracing) into `log_dir`. It records the CPU, and the card's
  kernels too where CUDA is available.
- `annotate(name)`: a named span (`torch.profiler.record_function`)
  visible in the trace.
- `LatencyHistogram`: per-round latency percentiles (a copy of JAX's).

`profile_round.py` and `profile_train.py` keep their own trace code,
which also sums device time by kernel class.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List

import numpy as np
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


def annotate(name: str):
    return record_function(name)


class LatencyHistogram:
    def __init__(self):
        self.samples: List[float] = []

    def add(self, seconds: float):
        self.samples.append(float(seconds))

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        a = np.asarray(self.samples)
        return {
            "count": int(a.size),
            "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean()),
            "max": float(a.max()),
        }
