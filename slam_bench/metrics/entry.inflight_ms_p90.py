"""Entry (`slam.SLAM.run`): p90 of a frame's time in flight, host ms from its
window's dispatch to its commit (the per-frame callback), over the frames
committed in the window (`program_trace`, which prints the count)."""

from slam_bench import program_trace
from slam_bench.record import p90


def read(rec):
    t = program_trace.of(rec)
    got = t.inflight_ms() if t else []
    return p90(got) if len(got) >= 2 else None
