"""Tracker and window program (``track.fuse`` + ``track.promote``): the
fusion, the keyframe decision and the promotion's IF node, device ms a
frame, from the window graph's stamps (`program_trace`)."""

from slam_bench import program_trace


def read(rec):
    t = program_trace.of(rec)
    return t.stage_ms_per_frame("track.fuse", "track.promote") if t else None
