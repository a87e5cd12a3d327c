"""Entry (`slam.SLAM.run`): the gap between replays, ms a frame, on the
device clock: ``window.end`` of replay n to ``window.begin`` of n + 1, over
the frames of the windows the gaps follow (`program_trace`). Read without
the profiler, over the whole measured window. An upper bound on the card's
idle time, not an idle share: the gap also holds device work outside the
stamps (the window's copies in and clones out, the upload)."""

from slam_bench import program_trace


def read(rec):
    t = program_trace.of(rec)
    return t.gap_ms_per_frame() if t else None
