"""CUDA runtime launch calls (kernels and graph replays) per interactive
round, the median over the traced rounds: the host's share of the round,
which launch graphs would cut."""

import statistics

LAYER = "round orchestration"
MOVES = "round_p90_ms"


def read(trace):
    spans = trace.spans.get("bench.round", [])
    if not spans or len(trace.rt_start) == 0:
        return None
    return float(statistics.median(trace.launches(a, b) for a, b in spans))
