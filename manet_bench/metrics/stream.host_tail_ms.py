"""A stream frame's host tail: the end of each `manet.observe` span less
the end of the last CUDA runtime call that ends inside it, the median
over the traced frames, in ms. That call is the download's synchronize
on the download pool's thread, which returns when the mask is on the
host; the tail is then the unpack there and the hand-back, which the
profiler, thread-local, records no span for. Runtime calls are on the
host's clock, as the spans are; the device's own intervals are not read:
on the card they shift against the spans by a few ms in some traced
slices. None where the program records no such span, or the trace holds
no device operation."""

import re
import statistics

import numpy as np

LAYER = "stream orchestration"
MOVES = "frame_p95_ms"
SPAN = "manet.observe"
RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def read(trace):
    spans = [(a, b) for n, a, b in zip(trace.op_name, trace.op_start,
                                       trace.op_end) if n == SPAN]
    if not spans or len(trace.dev_start) == 0:
        return None
    rt = np.asarray([RUNTIME.match(n) is not None for n in trace.op_name],
                    bool)
    ends = np.sort(trace.op_end[rt])
    tails = []
    for a, b in spans:
        i = int(np.searchsorted(ends, b, side="right")) - 1
        if i >= 0 and ends[i] > a:
            tails.append(int(b - ends[i]))
    if not tails:
        return None
    return statistics.median(tails) / 1e6
