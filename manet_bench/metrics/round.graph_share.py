"""The share of the rounds' sweep steps that replayed a captured CUDA
graph: 100 x the program's `manet.round.replay` spans over its
`manet.round.step` spans in the traced slice, in %. None where the
program records no step span, or the trace holds no device operation."""

LAYER = "round orchestration"
MOVES = "round_p90_ms"
STEP, REPLAY = "manet.round.step", "manet.round.replay"


def read(trace):
    steps = sum(n == STEP for n in trace.op_name)
    if not steps or len(trace.dev_start) == 0:
        return None
    return 100.0 * sum(n == REPLAY for n in trace.op_name) / steps
