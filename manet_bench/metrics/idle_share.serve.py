"""The device's idle share while serving: 1 minus the union of the
device's operation intervals in the traced slice over the wall of the
same slice run untraced just before it (the profiler's own cost then
counts in neither), in %."""

LAYER = "device"
MOVES = "frames_per_s"


def read(trace):
    if len(trace.dev_start) == 0:
        return None
    a, b = trace.window()
    return 100.0 * (1.0 - trace.busy_ns(a, b) / 1e9 / trace.info["wall_s"])
