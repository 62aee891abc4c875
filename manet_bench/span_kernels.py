"""Device time of the kernels that the program launched inside its own
spans: the traced run of `tracing.py`, with each launch call tied to the
device operation it launched.

The profiler gives a CUDA runtime launch call and the kernel it launched
the same correlation id. `SpanTrace` is `tracing.Trace` with those ids
(`rt_corr` beside `rt_start`, `dev_corr` beside `dev_start`) and the
launching thread (`rt_thread`); `launched_ns(trace, span)` is the device
time of the kernels whose launch calls lie inside a program span of that
name (`op_name`, e.g. `manet.batch.encode`) on the span's own thread.
Kernels launched through a runtime that the profiler does not see (the
program's own kernel libraries, `global_matching_roofline`'s docstring)
are not tied to any span; the FEELVOS encoder and head launch none.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from manet_bench.tracing import LAUNCH_CALLS, Trace


@dataclasses.dataclass
class SpanTrace(Trace):
    rt_corr: np.ndarray = None      # correlation id of each launch call
    rt_thread: np.ndarray = None    # and the thread that made it
    dev_corr: np.ndarray = None     # correlation id of each device op

    @classmethod
    def from_profiler(cls, prof, info: dict) -> "SpanTrace":
        from torch.autograd import DeviceType
        base = Trace.from_profiler(prof, info)
        rt_corr, rt_thread, dev_corr = [], [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            ann = (getattr(e, "is_user_annotation", lambda: False)()
                   or name.startswith("bench."))
            if e.device_type() == DeviceType.CUDA:
                if not ann:
                    dev_corr.append(e.correlation_id())
            elif name in LAUNCH_CALLS:
                rt_corr.append(e.correlation_id())
                rt_thread.append(e.start_thread_id())
        if len(rt_corr) != len(base.rt_start) or \
                len(dev_corr) != len(base.dev_start):
            raise RuntimeError("the profiler's events changed between reads")
        fields = {f.name: getattr(base, f.name)
                  for f in dataclasses.fields(Trace)}
        return cls(**fields, rt_corr=np.asarray(rt_corr, np.int64),
                   rt_thread=np.asarray(rt_thread, np.int64),
                   dev_corr=np.asarray(dev_corr, np.int64))


def launched_ns(trace, span: str):
    """Device ns of the kernels launched inside the spans named `span`,
    on each span's thread; None where the trace has no such span, no
    correlation ids (a plain `Trace`) or no device operation."""
    if getattr(trace, "rt_corr", None) is None or len(trace.dev_start) == 0:
        return None
    idx = [i for i, n in enumerate(trace.op_name) if n == span]
    if not idx:
        return None
    inside = np.zeros(len(trace.rt_start), bool)
    for i in idx:
        inside |= ((trace.rt_start >= trace.op_start[i])
                   & (trace.rt_start <= trace.op_end[i])
                   & (trace.rt_thread == trace.op_thread[i]))
    hit = np.isin(trace.dev_corr, trace.rt_corr[inside])
    return int((trace.dev_end[hit] - trace.dev_start[hit]).sum())
