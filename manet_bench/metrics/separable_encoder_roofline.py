"""FEELVOS's separable encoder (Xception-65, the separable ASPP and
decoder, the embedding) against its roofline: the least time of the
traced slice's encoder work at real frames (`counting_feelvos.py`: the
sum over layers of max(operations / bf16 peak, bytes / bandwidth)) over
the device time of the kernels launched inside the program's
`manet.batch.encode` spans (`span_kernels.py`), in %. None where the
program records no such span or the trace holds no device operation."""

from manet_bench.span_kernels import launched_ns

LAYER = "separable encoder"
MOVES = "frames_per_s"
SPAN = "manet.batch.encode"
WORK = "separable_encoder_least_s"


def read(trace):
    least = trace.info.get(WORK)
    ns = launched_ns(trace, SPAN)
    if least is None or not ns:
        return None
    return 100.0 * least / (ns / 1e9)
