"""The protocol's share of a submission: the program's
`manet.session.submit` span (`InteractiveSession.submit_masks`: the
ground truth read, J and F of every object and frame, and the robot's
next scribbles), the median over the traced submissions, in ms. None
where the program records no such span, or the trace holds no device
operation."""

import statistics

LAYER = "protocol stack"
MOVES = "round_p90_ms"
SPAN = "manet.session.submit"


def read(trace):
    spans = [(a, b) for n, a, b in zip(trace.op_name, trace.op_start,
                                       trace.op_end) if n == SPAN]
    if not spans or len(trace.dev_start) == 0:
        return None
    return statistics.median(int(b - a) for a, b in spans) / 1e6
