"""Kernel 7 (`manet::group_norm`)'s share of the traced slice's GroupNorm
statistics launches, in %: the device operations named as its statistics
kernel over those plus aten's statistics kernel
(`RowwiseMomentsCUDAKernel`, which the f32 chain `F.group_norm(x.float())`
launches once a norm). 0 where every norm takes aten's chain, 100 where
every bf16 norm takes kernel 7. Counted over the whole traced slice, by
name: kernel 7 launches through the CUDA runtime linked into its own
library, whose calls the profiler does not see. Nothing to read (None)
where neither kernel ran."""

LAYER = "kernel 7 GroupNorm"
MOVES = "frames_per_s"
FUSED = "group_norm_stats"
ATEN = "RowwiseMomentsCUDAKernel"


def read(trace):
    fused = sum(FUSED in name for name in trace.dev_name)
    aten = sum(ATEN in name for name in trace.dev_name)
    if fused + aten == 0:
        return None
    return 100.0 * fused / (fused + aten)
