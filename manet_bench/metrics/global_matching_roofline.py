"""Kernel 1 in bf16 (`manet::global_matching`): query rows of the round's real frames against the annotated frame's labelled pixels, against the bf16 peak.

The share of the roofline: the least time of the traced calls' work
(`counting.py`) over the device time of the kernels named here, in %.
The kernels are found by name: they launch through the CUDA runtime
linked into their own library, whose calls the profiler does not see, so
they cannot be tied to the op that launched them. Only this one family
of global-matching kernels runs in the cells that list this metric; if a
change renames a kernel, a later benchmark change repoints the
pattern."""

from manet_bench.counting import share

LAYER = "kernel 1 bf16 global matching"
MOVES = "frames_per_s"
KERNELS = r"global_matching_wgmma<false, false>|merge_splits"


def read(trace):
    work = trace.info["kernels"].get("global_matching")
    if work is None or len(trace.dev_start) == 0:
        return None
    return share(work, trace.named_kernel_ns(KERNELS))
