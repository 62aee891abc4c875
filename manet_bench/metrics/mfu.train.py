"""The whole training step's share of the chip's peak: three times the
forward's model FLOPs (forward and backward; the checkpointed recompute
not counted) of the traced steps' samples (`counting.py`) over the
steps' untraced wall times the bf16 peak, in %."""

from manet_bench.counting import PEAK

LAYER = "whole step"
MOVES = "train_samples_per_s"


def read(trace):
    if len(trace.dev_start) == 0:
        return None
    return 100.0 * trace.info["flops"] / (trace.info["wall_s"] * PEAK["bf16"])
