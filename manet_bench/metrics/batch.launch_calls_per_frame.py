"""CUDA runtime launch calls (kernels and graph replays) inside each
`bench.batch` span over the batch's real (unpadded) frames, the median
over the traced batches: the host's share of the batch, which launch
graphs would cut."""

import statistics

LAYER = "batch orchestration"
MOVES = "frames_per_s"


def read(trace):
    spans = trace.spans.get("bench.batch", [])
    frames = trace.info.get("batches", [])
    if not spans or len(spans) != len(frames) or len(trace.rt_start) == 0:
        return None
    return statistics.median(trace.launches(a, b) / n
                             for (a, b), n in zip(spans, frames))
