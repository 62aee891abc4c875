"""CUDA runtime launch calls (kernels and graph replays) per training
step, the median over the traced steps: the host's share of the step."""

import statistics

LAYER = "training loop"
MOVES = "train_samples_per_s"


def read(trace):
    spans = trace.spans.get("bench.step", [])
    if not spans or len(trace.rt_start) == 0:
        return None
    return float(statistics.median(trace.launches(a, b) for a, b in spans))
