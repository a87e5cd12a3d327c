"""Device (H100): the profiled slice's idle share, in %: 1 - the union of
kernel, memcpy and memset intervals over the slice's length (`trace`). An
upper reading: under the profiler a captured graph's launch takes longer
and the gaps between replays widen, so the untraced window idles less."""


def read(rec):
    s = rec.summary
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
