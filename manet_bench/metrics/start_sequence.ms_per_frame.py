"""`Evaluator.start_sequence` (upload, normalization, the encoder over the
frame bucket), timed by the harness's span, which a synchronize closes in
the traced run, over the video's real frames: the median over the traced
sessions, in ms a frame."""

import statistics

LAYER = "sequence start and encoder"
MOVES = "frames_per_s"


def read(trace):
    spans = trace.spans.get("bench.start_sequence", [])
    starts = trace.info.get("starts", [])
    if not spans or len(spans) != len(starts):
        return None
    return statistics.median((b - a) / 1e6 / s["frames"]
                             for (a, b), s in zip(spans, starts))
