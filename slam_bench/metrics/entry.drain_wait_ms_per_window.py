"""Entry (`tracker.FrameTracker.sync_chain`): host ms the drain's one read
(``tracker.drain_read``) waits, per drained window (`program_trace`)."""

from slam_bench import program_trace


def read(rec):
    t = program_trace.of(rec)
    return t.span_ms_mean("tracker.drain_read") if t else None
