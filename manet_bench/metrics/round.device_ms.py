"""Device time per interactive round: the union of the device's
operation intervals inside each round's span, the median over the traced
rounds, in ms."""

import statistics

LAYER = "round orchestration"
MOVES = "round_p90_ms"


def read(trace):
    spans = trace.spans.get("bench.round", [])
    if not spans or len(trace.dev_start) == 0:
        return None
    return statistics.median(trace.busy_ns(a, b) for a, b in spans) / 1e6
