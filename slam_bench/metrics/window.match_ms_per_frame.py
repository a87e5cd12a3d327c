"""Tracker and window program (``track.match``): the dense matcher's device
ms a frame, from the window graph's stamps (`program_trace`)."""

from slam_bench import program_trace


def read(rec):
    t = program_trace.of(rec)
    return t.stage_ms_per_frame("track.match") if t else None
