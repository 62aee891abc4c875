"""Host-blocking runtime calls inside the round's enqueue: the CUDA
runtime's and driver's synchronize calls on the thread of each
`manet.round.dispatch` span and inside it, the median over the traced
rounds. A pageable upload synchronizes its stream, so each one counts;
a launch graph cannot capture an enqueue that reads above 0. None where
the program records no such span, or the trace holds no device
operation."""

import statistics

import numpy as np

LAYER = "round orchestration"
MOVES = "round_p90_ms"
SPAN = "manet.round.dispatch"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cuStreamSynchronize",
              "cuCtxSynchronize")


def read(trace):
    spans = [(a, b, t) for n, a, b, t in zip(
        trace.op_name, trace.op_start, trace.op_end, trace.op_thread)
        if n == SPAN]
    if not spans or len(trace.dev_start) == 0:
        return None
    sync = np.asarray([n in SYNC_CALLS for n in trace.op_name], bool)
    start, thread = trace.op_start[sync], trace.op_thread[sync]
    return float(statistics.median(
        int(((start >= a) & (start <= b) & (thread == t)).sum())
        for a, b, t in spans))
