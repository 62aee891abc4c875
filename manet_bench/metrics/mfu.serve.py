"""The whole serving step's share of the chip's peak: the model FLOPs
that the traced slice's work needs (encoder, heads and matching at the
real frame and object counts, `counting.py`) over the slice's untraced
wall times the bf16 peak, in %."""

from manet_bench.counting import PEAK

LAYER = "whole step"
MOVES = "frames_per_s"


def read(trace):
    if len(trace.dev_start) == 0:
        return None
    return 100.0 * trace.info["flops"] / (trace.info["wall_s"] * PEAK["bf16"])
