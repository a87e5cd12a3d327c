"""What one run records, for the end-to-end metrics, the per-layer readers
(``metrics/<name>.py``, each ``read(record) -> float | None``) and the
check."""

from __future__ import annotations

import contextlib
import statistics
from dataclasses import dataclass, field


@dataclass
class Record:
    seconds: float
    trace: bool
    t_proc: float  # process start, host clock
    shapes: object = None  # cost.Shapes of the cell's configuration
    t0: float | None = None  # the window's first frame taken
    t_close: float | None = None  # the close seen at a frame request
    taken: dict = field(default_factory=dict)  # frame id -> host time taken from the loader
    commits: list = field(default_factory=list)  # (frame id, taken, committed)
    frames_in_close: int = 0  # frames taken from t0 to the close
    peak_bytes: int = 0
    events: dict = field(default_factory=dict)  # event counts over [t0, t_close]
    slice_events: dict = field(default_factory=dict)  # event counts over the profiled slice
    syncs: int | None = None
    sync_sites: dict = field(default_factory=dict)
    dispatch: list = field(default_factory=list)  # (device ms, frames) per dispatch_window
    summary: dict | None = None  # trace.summarize of the slice

    @property
    def t1(self) -> float:
        return self.t0 + self.seconds

    def window_commits(self) -> list:
        return [c for c in self.commits if self.t0 <= c[2] < self.t1]

    def span(self, name: str):
        if not self.trace:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)


def p90(values: list) -> float:
    """The 90th percentile, interpolated between order statistics."""
    return statistics.quantiles(values, n=10, method="inclusive")[8]
