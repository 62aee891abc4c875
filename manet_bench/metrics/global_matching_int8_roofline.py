"""Kernel 3 (`manet::global_matching_int8`, with its split merge): the frame's rows against the labelled rows of the filled memory pages, against the int8 peak.

The share of the roofline: the least time of the traced calls' work
(`counting.py`) over the device time of the kernels named here, in %.
The kernels are found by name: they launch through the CUDA runtime
linked into their own library, whose calls the profiler does not see, so
they cannot be tied to the op that launched them. Only this one family
of global-matching kernels runs in the cells that list this metric; if a
change renames a kernel, a later benchmark change repoints the
pattern."""

from manet_bench.counting import share

LAYER = "kernel 3 int8 global matching"
MOVES = "frames_per_s"
KERNELS = r"global_matching_wgmma<false, true>|merge_splits"


def read(trace):
    work = trace.info["kernels"].get("global_matching_int8")
    if work is None or len(trace.dev_start) == 0:
        return None
    return share(work, trace.named_kernel_ns(KERNELS))
