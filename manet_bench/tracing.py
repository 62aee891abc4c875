"""The traced run: one profiler over a slice of the cell's traffic, and
its reduction to what the metric readers need.

The profiler (`torch.profiler`, CUPTI on the card) records the device's
operations, the CUDA runtime calls that launched them, the program's ops
and the harness's own spans (`bench.*`, `record_function`). `Trace`
holds them as sorted arrays on one clock (nanoseconds), with:

- `busy_ns(a, b)`: the union of device operation intervals inside
  [a, b], so that overlapping operations count once;
- `launches(a, b)`: the runtime's launch calls (kernels and graphs)
  issued inside [a, b];
- `named_kernel_ns(pattern)`: the device time of the kernels whose names
  match a regular expression;
- `breakdown()`: the device operations that took most time and the
  longest idle gaps, named by the innermost host op they fell in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re

import numpy as np

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


@contextlib.contextmanager
def span(name: str):
    """A harness span: recorded while the profiler runs, free otherwise."""
    import torch
    with torch.profiler.record_function(name):
        yield


def profiler(device):
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if getattr(device, "type", device) == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def _merge(starts, ends):
    """Sorted, disjoint union of intervals."""
    if len(starts) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(s) - 1)
    return s[idx], run_end[last]


@dataclasses.dataclass
class Trace:
    dev_start: np.ndarray       # device operations
    dev_end: np.ndarray
    dev_name: list
    rt_start: np.ndarray        # runtime launch calls
    op_name: list               # host ops and spans
    op_start: np.ndarray
    op_end: np.ndarray
    op_thread: np.ndarray
    spans: dict                 # harness span name -> [(start, end)]
    info: dict                  # the traffic driver's account of the traced work

    def __post_init__(self):
        self.busy_start, self.busy_end = _merge(self.dev_start, self.dev_end)

    @classmethod
    def from_profiler(cls, prof, info: dict) -> "Trace":
        from torch.autograd import DeviceType
        dev, rt, ops = [], [], []
        spans: dict[str, list] = {}
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            ann = (getattr(e, "is_user_annotation", lambda: False)()
                   or name.startswith("bench."))
            if e.device_type() == DeviceType.CUDA:
                if not ann:      # a span's device-side shadow is no work
                    dev.append((e.start_ns(), e.end_ns(), name))
            elif name in LAUNCH_CALLS:
                rt.append(e.start_ns())
            else:
                ops.append((name, e.start_ns(), e.end_ns(),
                            e.start_thread_id()))
                if ann and name.startswith("bench."):
                    spans.setdefault(name, []).append(
                        (e.start_ns(), e.end_ns()))
        for v in spans.values():
            v.sort()

        def col(rows, i, dtype=np.int64):
            return np.asarray([r[i] for r in rows], dtype=dtype)

        return cls(dev_start=col(dev, 0), dev_end=col(dev, 1),
                   dev_name=[r[2] for r in dev],
                   rt_start=np.asarray(rt, np.int64),
                   op_name=[r[0] for r in ops],
                   op_start=col(ops, 1), op_end=col(ops, 2),
                   op_thread=col(ops, 3), spans=spans, info=info)

    # ------------------------------------------------------------ reads

    def window(self) -> tuple[int, int]:
        (a, b), = self.spans["bench.window"]
        return a, b

    def busy_ns(self, a: int, b: int) -> int:
        s = np.clip(self.busy_start, a, b)
        e = np.clip(self.busy_end, a, b)
        return int((e - s).sum())

    def launches(self, a: int, b: int) -> int:
        return int(((self.rt_start >= a) & (self.rt_start <= b)).sum())

    def _kernel_ns(self, mask) -> int:
        return int((self.dev_end[mask] - self.dev_start[mask]).sum())

    def named_kernel_ns(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return self._kernel_ns(np.asarray(
            [rx.search(n) is not None for n in self.dev_name], bool))

    def breakdown(self, top: int = 10) -> dict:
        a, b = self.window()
        inside = (self.dev_start >= a) & (self.dev_end <= b)
        by_name: dict[str, int] = {}
        for n, d in zip(np.asarray(self.dev_name, object)[inside],
                        (self.dev_end - self.dev_start)[inside]):
            key = n[:120]
            by_name[key] = by_name.get(key, 0) + int(d)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        # idle gaps between busy intervals inside the window
        s = np.clip(self.busy_start, a, b)
        e = np.clip(self.busy_end, a, b)
        g_start = np.concatenate([[a], e])
        g_end = np.concatenate([s, [b]])
        length = g_end - g_start
        gaps = []
        for i in np.argsort(-length)[:top]:
            if length[i] <= 0:
                break
            gaps.append([self.host_op_at((g_start[i] + g_end[i]) // 2),
                         float(length[i]) / 1e9])
        return {"device_ops": [[n, d / 1e9] for n, d in ops],
                "idle_gaps": gaps}

    def host_op_at(self, t: int) -> str:
        """The innermost host op or span running at `t` on the thread
        that opened the window."""
        main = self.op_thread[self.op_name.index("bench.window")] \
            if "bench.window" in self.op_name else None
        m = (self.op_start <= t) & (self.op_end >= t)
        if main is not None:
            m &= self.op_thread == main
        idx = np.flatnonzero(m)
        if len(idx) == 0:
            return "(no host op)"
        return self.op_name[idx[np.argmax(self.op_start[idx])]][:120]
