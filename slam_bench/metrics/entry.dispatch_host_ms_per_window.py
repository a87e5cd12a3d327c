"""Entry (`tracker.FrameTracker.dispatch_window`): host ms of a window's
dispatch (``tracker.dispatch_window``: preparation, copies in, the launch,
clones out), per window (`program_trace`)."""

from slam_bench import program_trace


def read(rec):
    t = program_trace.of(rec)
    return t.span_ms_mean("tracker.dispatch_window") if t else None
