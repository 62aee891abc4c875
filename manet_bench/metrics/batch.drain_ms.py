"""A batch's drain: the program's `manet.batch.drain` span (the wait for
the packed labels' downloads and their host unpack into int32 label
maps), the median over the traced batches, in ms. None where the program
records no such span, or the trace holds no device operation."""

import statistics

LAYER = "batch orchestration"
MOVES = "frames_per_s"
SPAN = "manet.batch.drain"


def read(trace):
    spans = [(a, b) for n, a, b in zip(trace.op_name, trace.op_start,
                                       trace.op_end) if n == SPAN]
    if not spans or len(trace.dev_start) == 0:
        return None
    return statistics.median(int(b - a) for a, b in spans) / 1e6
