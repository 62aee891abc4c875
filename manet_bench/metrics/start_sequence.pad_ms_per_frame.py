"""`Evaluator.start_sequence`'s host padding (frames padded to the stride
and the frame bucket with the mean pixel): the program's
`manet.start.pad` span over the video's real frames, the median over the
traced sessions, in ms a frame. None where the program records no such
span, or the trace holds no device operation."""

import statistics

LAYER = "sequence start and encoder"
MOVES = "frames_per_s"
SPAN = "manet.start.pad"


def read(trace):
    spans = sorted((a, b) for n, a, b in zip(trace.op_name, trace.op_start,
                                             trace.op_end) if n == SPAN)
    starts = trace.info.get("starts", [])
    if not spans or len(spans) != len(starts) or len(trace.dev_start) == 0:
        return None
    return statistics.median(int(b - a) / 1e6 / s["frames"]
                             for (a, b), s in zip(spans, starts))
