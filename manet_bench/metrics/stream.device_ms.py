"""Device time per `StreamingIVOS.observe`: the union of the device's
operation intervals inside each observe's span, the median over the
traced frames, in ms."""

import statistics

LAYER = "stream orchestration"
MOVES = "frame_p95_ms"


def read(trace):
    spans = trace.spans.get("bench.observe", [])
    if not spans or len(trace.dev_start) == 0:
        return None
    return statistics.median(trace.busy_ns(a, b) for a, b in spans) / 1e6
