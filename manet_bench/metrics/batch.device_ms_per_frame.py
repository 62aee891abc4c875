"""Device time per real frame of a batch: the union of the device's
operation intervals inside each `bench.batch` span (the batch's dispatch,
the next batch's upload and encoder, its drain: one batch's work in the
pipelined steady state) over the batch's real (unpadded) frames, the
median over the traced batches, in ms a frame."""

import statistics

LAYER = "batch orchestration"
MOVES = "frames_per_s"


def read(trace):
    spans = trace.spans.get("bench.batch", [])
    frames = trace.info.get("batches", [])
    if not spans or len(spans) != len(frames) or len(trace.dev_start) == 0:
        return None
    return statistics.median(trace.busy_ns(a, b) / 1e6 / n
                             for (a, b), n in zip(spans, frames))
