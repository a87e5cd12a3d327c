"""Tracker and window program (`tracker.FrameTracker.dispatch_window`, one
replay of `graphs.WindowGraph`): device ms per tracked frame, CUDA events on
the current stream around each dispatch in the window, summed."""


def read(rec):
    frames = sum(n for _, n in rec.dispatch)
    return sum(ms for ms, _ in rec.dispatch) / frames if frames else None
