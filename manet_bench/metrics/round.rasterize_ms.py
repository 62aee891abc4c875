"""The round's scribble rasterization on the host (`annotated_frames`,
`scribbles2mask`, the padding): the program's `manet.round.rasterize`
span, the median over the traced rounds, in ms. None where the program
records no such span, or the trace holds no device operation."""

import statistics

LAYER = "round orchestration"
MOVES = "round_p90_ms"
SPAN = "manet.round.rasterize"


def read(trace):
    spans = [(a, b) for n, a, b in zip(trace.op_name, trace.op_start,
                                       trace.op_end) if n == SPAN]
    if not spans or len(trace.dev_start) == 0:
        return None
    return statistics.median(int(b - a) for a, b in spans) / 1e6
