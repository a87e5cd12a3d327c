"""Tracker and window program (`graphs.GraphCache.window`): seconds of
set-up spent capturing window graphs, the outermost ``graph.capture`` spans
before the window opens (warm-up, branch bodies and capture;
`program_trace`)."""

from slam_bench import program_trace


def read(rec):
    t = program_trace.of(rec)
    return t.capture_s() if t else None
