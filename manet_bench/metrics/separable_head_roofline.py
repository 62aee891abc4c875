"""FEELVOS's separable 7x7 dynamic head against its roofline: the least
time of the traced slice's head work (`counting_feelvos.py`: the
features' share of the first layer once a real propagated frame, the
rest once a live object of it, background included) over the device
time of the kernels launched inside the program's `manet.batch.head`
spans (`span_kernels.py`), in %. None where the program records no such
span or the trace holds no device operation."""

from manet_bench.span_kernels import launched_ns

LAYER = "separable head"
MOVES = "frames_per_s"
SPAN = "manet.batch.head"
WORK = "separable_head_least_s"


def read(trace):
    least = trace.info.get(WORK)
    ns = launched_ns(trace, SPAN)
    if least is None or not ns:
        return None
    return 100.0 * least / (ns / 1e9)
