"""Tracker and window program (`tracker.make_track_step`, ``track.encode``):
the encode's device ms a frame, from the port's stamps captured into the
window graph (`program_trace`), summed over the window's replays and their
frames. Nothing when the port ran untraced."""

from slam_bench import program_trace


def read(rec):
    t = program_trace.of(rec)
    return t.stage_ms_per_frame("track.encode") if t else None
