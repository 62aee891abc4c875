"""The round's host tail after its masks arrive: the program's
`manet.round.unpack` spans (bit unpacking, the mask-stride repeat, the
crop and the int32 cast) summed within each `manet.round` span, the
median over the traced rounds, in ms. None where the program records no
such span, or the trace holds no device operation."""

import statistics

LAYER = "round orchestration"
MOVES = "round_p90_ms"
OUTER, SPAN = "manet.round", "manet.round.unpack"


def read(trace):
    rows = list(zip(trace.op_name, trace.op_start, trace.op_end,
                    trace.op_thread))
    rounds = [(a, b, t) for n, a, b, t in rows if n == OUTER]
    unpack = [(a, b, t) for n, a, b, t in rows if n == SPAN]
    if not rounds or not unpack or len(trace.dev_start) == 0:
        return None
    return statistics.median(
        sum(int(e - s) for s, e, u in unpack if a <= s and e <= b and u == t)
        for a, b, t in rounds) / 1e6
