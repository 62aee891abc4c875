"""A stream frame's ingest: the program's `manet.observe.ingest` span
(the host padding and the upload, which waits for the copy), the median
over the traced frames, in ms. None where the program records no such
span, or the trace holds no device operation."""

import statistics

LAYER = "stream orchestration"
MOVES = "frame_p95_ms"
SPAN = "manet.observe.ingest"


def read(trace):
    spans = [(a, b) for n, a, b in zip(trace.op_name, trace.op_start,
                                       trace.op_end) if n == SPAN]
    if not spans or len(trace.dev_start) == 0:
        return None
    return statistics.median(int(b - a) for a, b in spans) / 1e6
