"""Tracker and window program (``track.pose``): the pose Gauss-Newton's
device ms a frame, gates and core included, from the window graph's stamps
(`program_trace`)."""

from slam_bench import program_trace


def read(rec):
    t = program_trace.of(rec)
    return t.stage_ms_per_frame("track.pose") if t else None
