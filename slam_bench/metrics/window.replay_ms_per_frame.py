"""Tracker and window program (`graphs.WindowGraph`): device ms a frame from
each replay's ``window.begin`` stamp to its ``window.end`` (`program_trace`),
without the host's preparation that `track.device_ms_per_frame`'s events
take in."""

from slam_bench import program_trace


def read(rec):
    t = program_trace.of(rec)
    return t.replay_ms_per_frame() if t else None
