"""Tracker and window program (``track.decode``): the two-view decode's
device ms a frame, from the window graph's stamps (`program_trace`)."""

from slam_bench import program_trace


def read(rec):
    t = program_trace.of(rec)
    return t.stage_ms_per_frame("track.decode") if t else None
