"""Kernel 4 (`global_matching_prepared_argmin`, bf16, with its split
merge): each sample's current frame against the reference frame's
labelled pixels, against the bf16 peak. Kernel 4 is no registered op and
its callers bind it by name, so its device time is that of the kernels
named here: if a change renames them, a later benchmark change repoints
the pattern. The share of the roofline, in %."""

from manet_bench.counting import share

LAYER = "kernel 4 global matching argmin"
MOVES = "train_samples_per_s"
KERNELS = r"global_matching_wgmma<true, false>|merge_splits"


def read(trace):
    work = trace.info["kernels"].get("global_matching_argmin")
    if work is None or len(trace.dev_start) == 0:
        return None
    return share(work, trace.named_kernel_ns(KERNELS))
