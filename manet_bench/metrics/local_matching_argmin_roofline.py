"""Kernel 5 (`local_matching_prepared_argmin`): each sample's current
frame against the previous frame within the window (the in-window pairs),
twice a sample (the forward and the checkpointed recompute), against the
TF32 peak. Its device time is that of the kernels named here. The share
of the roofline, in %."""

from manet_bench.counting import share

LAYER = "kernel 5 local matching argmin"
MOVES = "train_samples_per_s"
KERNELS = r"local_matching_tf32<\d+, true>"


def read(trace):
    work = trace.info["kernels"].get("local_matching_argmin")
    if work is None or len(trace.dev_start) == 0:
        return None
    return share(work, trace.named_kernel_ns(KERNELS))
