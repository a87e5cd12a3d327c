"""The port's own trace (`mast3r_slam_torch.utils.profiling.TRACER`), read in
the run's process once `SLAM.run` has returned, over the measured window:
the windows whose ``window.begin`` stamp maps inside ``[rec.t0,
rec.t_close)``, the host spans that start inside it, and the frames
committed inside it. `of(rec)` is what the readers ``metrics/window.*``,
``metrics/entry.window_gap_ms_per_frame``, ``entry.drain_wait_ms_per_window``,
``entry.dispatch_host_ms_per_window``, ``entry.inflight_ms_p90`` and
``setup.capture_s`` take; it is None when the port ran untraced, so they
read nothing then.

    python3 -m slam_bench.program_trace --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(a temporary runner, `main`) runs ``slam_bench.run`` as it is, with
``runtime.trace`` merged into the cell's settings: with ``--trace 0`` its
end-to-end metrics (the tracer's cost when on), with ``--trace 1`` its
per-layer metrics and `METRICS`, and on standard error the clock's
calibration, the gaps between replays (device clock) by the host span over
them, and the stamp kernels' times in the profiled slice against their
mapped stamps.
"""

from __future__ import annotations

import bisect
import sys
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

METRICS = (
    ("window.encode_ms_per_frame", "ms"),
    ("window.decode_ms_per_frame", "ms"),
    ("window.match_ms_per_frame", "ms"),
    ("window.pose_ms_per_frame", "ms"),
    ("window.fuse_ms_per_frame", "ms"),
    ("window.replay_ms_per_frame", "ms"),
    ("entry.window_gap_ms_per_frame", "ms"),
    ("entry.drain_wait_ms_per_window", "ms"),
    ("entry.dispatch_host_ms_per_window", "ms"),
    ("entry.inflight_ms_p90", "ms"),
    ("setup.capture_s", "s"),
)
STAMP_KERNEL = "stamp_kernel"
_SLICE: dict = {}  # the profiled slice's events, kept by `main`


@dataclass
class Window:
    """One traced window's row on the host clock (ns)."""

    begin: float
    end: float
    frames: int  # frame slots with stamps
    stages: dict = field(default_factory=dict)  # stage name -> ns, summed over its frames


def windows_of(rows: list) -> list[Window]:
    """`Tracer.device_rows` -> Windows sorted by begin, each stage's time
    from `profiling.stage_ns`."""
    from mast3r_slam_torch.utils.profiling import WINDOW_BEGIN, WINDOW_END, stage_ns

    out = []
    for row in rows:
        stamps = row["stamps"]
        if not stamps or stamps[0][0] != WINDOW_BEGIN or stamps[-1][0] != WINDOW_END:
            continue
        slots = {slot for _n, slot, _e, _t in stamps if slot is not None}
        out.append(Window(stamps[0][3], stamps[-1][3], len(slots), stage_ns(stamps)))
    return sorted(out, key=lambda w: w.begin)


def self_segments(spans: list) -> list[tuple]:
    """Each closed span's self intervals (its time less its children's) as
    sorted (start, end, name) on one thread's clock."""
    kids: dict = {}
    for s in spans:
        if s.t1 is not None and s.parent is not None:
            kids.setdefault(s.parent, []).append((s.t0, s.t1))
    segs = []
    for i, s in enumerate(spans):
        if s.t1 is None:
            continue
        cur = s.t0
        for a, b in sorted(kids.get(i, [])):
            if a > cur:
                segs.append((cur, min(a, s.t1), s.name))
            cur = max(cur, b)
        if s.t1 > cur:
            segs.append((cur, s.t1, s.name))
    return sorted(segs)


def attribute(gaps: list, segs: list) -> dict:
    """ns of the `gaps` [(start, end)] under each span's self time (`segs` of
    `self_segments`); ``none`` where no span was open."""
    starts = [s[0] for s in segs]
    out: dict = {}
    for a, b in gaps:
        covered = 0.0
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(segs) and segs[i][0] < b:
            s, e, name = segs[i]
            ov = min(e, b) - max(s, a)
            if ov > 0:
                out[name] = out.get(name, 0.0) + ov
                covered += ov
            i += 1
        if b - a > covered:
            out["none"] = out.get("none", 0.0) + (b - a - covered)
    return out


@dataclass
class Reading:
    """The trace over one measured window [t0, t1) (host ns)."""

    t0: float
    t1: float
    windows: list  # Window, begin inside [t0, t1)
    spans: list  # every host span of the run
    frames: dict  # frame id -> {taken, dispatched, drained, committed}
    clock: dict
    counters: dict

    @property
    def n_frames(self) -> int:
        return sum(w.frames for w in self.windows)

    def stage_ms_per_frame(self, *names: str):
        if not self.n_frames:
            return None
        return sum(w.stages.get(n, 0.0) for w in self.windows for n in names) / 1e6 / self.n_frames

    def replay_ms_per_frame(self):
        if not self.n_frames:
            return None
        return sum(w.end - w.begin for w in self.windows) / 1e6 / self.n_frames

    def gaps(self) -> list[tuple]:
        """(end of window n, begin of window n+1) on the host clock."""
        w = self.windows
        return [(a.end, b.begin) for a, b in zip(w, w[1:])]

    def gap_ms_per_frame(self):
        """The gaps between consecutive replays (an upper bound on the
        device's idle: copies and the upload run there too), over the frames
        of the windows each gap follows."""
        frames = sum(w.frames for w in self.windows[:-1])
        if not frames:
            return None
        return sum(max(0.0, b - a) for a, b in self.gaps()) / 1e6 / frames

    def spans_named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name and s.t1 is not None
                and self.t0 <= s.t0 < self.t1]

    def span_ms_mean(self, name: str):
        got = self.spans_named(name)
        return sum(s.t1 - s.t0 for s in got) / 1e6 / len(got) if got else None

    def inflight_ms(self) -> list:
        """dispatched -> committed of each frame committed in the window."""
        return [(m["committed"] - m["dispatched"]) / 1e6 for m in self.frames.values()
                if "committed" in m and "dispatched" in m
                and self.t0 <= m["committed"] < self.t1]

    def capture_s(self):
        """Set-up's captures: the graph.capture spans (outermost) that end
        before the window opens."""
        caps = [s for s in self.spans if s.name == "graph.capture" and s.t1 is not None
                and s.t1 <= self.t0]
        if not caps:
            return None

        def nested(s) -> bool:  # inside another capture (a branch body's)
            while s.parent is not None:
                s = self.spans[s.parent]
                if s.name == "graph.capture":
                    return True
            return False

        return sum(s.t1 - s.t0 for s in caps if not nested(s)) / 1e9

    def gap_by_span(self) -> dict:
        """ms of the gaps between replays under each host span's self time."""
        got = attribute([(a, b) for a, b in self.gaps() if b > a], self_segments(self.spans))
        return {k: v / 1e6 for k, v in sorted(got.items(), key=lambda kv: -kv[1])}


def read_tracer(tracer, t0_ns: float, t1_ns: float):
    """The `Reading` of `tracer` over [t0_ns, t1_ns), or None when it holds
    no device rows and no spans."""
    if not tracer.spans and not tracer.rows:
        return None
    wins = [w for w in windows_of(tracer.device_rows()) if t0_ns <= w.begin < t1_ns]
    return Reading(t0_ns, t1_ns, wins, list(tracer.spans), dict(tracer.frames), tracer.clock(),
                   dict(tracer.counters))


def stamp_agreement(events: list, reading: Reading, rows: list):
    """The stamp kernels of a torch.profiler trace against their stamps
    mapped to the host clock: the trace's clock is tied to the host's by the
    tracer's spans, which a profiled run also records as annotations (the
    offset of the most pairs of the same name, 20 us bins, then their
    median); each stamp kernel's start is compared with the nearest mapped
    stamp. -> (kernels, median |d| us, max |d| us), or None."""
    import numpy as np

    ann = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    by_name: dict = {}
    for s in reading.spans:
        by_name.setdefault(s.name, []).append(s.t0)
    cands = [e["ts"] * 1e3 - t for e in ann for t in by_name.get(e["name"], ())]
    if not cands:
        return None
    bins = np.round(np.asarray(cands) / 2e4)
    vals, counts = np.unique(bins, return_counts=True)
    mode = vals[np.argmax(counts)] * 2e4
    close = [c for c in cands if abs(c - mode) <= 5e4]
    offset = float(np.median(close))
    stamps = np.sort(np.array([t for r in rows for *_, t in r["stamps"]]))
    kernels = [e["ts"] * 1e3 - offset for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel" and STAMP_KERNEL in e["name"]]
    if not len(stamps) or not kernels:
        return None
    d = []
    for k in kernels:
        i = int(np.searchsorted(stamps, k))
        d.append(min(abs(stamps[j] - k) for j in (i - 1, i) if 0 <= j < len(stamps)) / 1e3)
    return len(d), float(np.median(d)), float(max(d))


def of(rec):
    """The port's trace over `rec`'s window (cached on `rec`), printing the
    clock, the gap attribution and the inflight samples on standard error
    the first time; None when the run was untraced or the port has no
    tracer."""
    if "_program_trace" in rec.__dict__:
        return rec.__dict__["_program_trace"]
    try:
        from mast3r_slam_torch.utils.profiling import TRACER
    except ImportError:  # a port without the tracer: nothing to read
        TRACER = None
    reading = None
    if TRACER is not None and rec.t0 is not None and rec.t_close is not None:
        reading = read_tracer(TRACER, rec.t0 * 1e9, rec.t_close * 1e9)
    rec.__dict__["_program_trace"] = reading
    if reading is not None:
        c = reading.clock
        print(f"[trace] clock: {c['pairs']} pairs, uncertainty {c['uncertainty_ns']} ns, drift "
              f"{c.get('drift_ns')} ns ({c.get('drift_ppm')} ppm); windows {len(reading.windows)}, "
              f"frames {reading.n_frames}; counters {reading.counters}", file=sys.stderr)
        print(f"[trace] gap by span {reading.gap_by_span()}", file=sys.stderr)
        print(f"[trace] inflight samples {len(reading.inflight_ms())}", file=sys.stderr)
        if _SLICE.get("events"):
            got = stamp_agreement(_SLICE["events"], reading, TRACER.device_rows())
            print(f"[trace] stamp kernels in the slice against their mapped stamps "
                  f"(kernels, median us, max us): {got}", file=sys.stderr)
    return reading


def main(argv: list[str] | None = None) -> int:
    """`slam_bench.run` with ``runtime.trace`` merged into the cell's
    settings and `METRICS` added to its per-layer metrics, by patching
    `manifest.cell` and `trace.load_events` while it runs. Temporary: it
    goes once `entries/slam_run.py` turns the tracer on under ``--trace 1``
    and `BENCHMARK.json` lists the eleven metrics (ROADMAP 5.8)."""
    from slam_bench import manifest, program_trace, run, trace
    from slam_bench.settings import merge

    plain_cell, plain_load = manifest.cell, trace.load_events

    def cell(name, root=manifest.ROOT):
        c = plain_cell(name, root)
        c.traffic = merge(c.traffic, {"settings": {"runtime": {"trace": True}}})
        c.per_layer = c.per_layer + [dict(name=n, unit=u) for n, u in METRICS]
        return c

    def load_events(path):  # for the readers' module, which `-m` runs apart from this one
        program_trace._SLICE["events"] = plain_load(path)
        return program_trace._SLICE["events"]

    manifest.cell, trace.load_events = cell, load_events
    try:
        return run.main(argv)
    finally:
        manifest.cell, trace.load_events = plain_cell, plain_load


if __name__ == "__main__":
    sys.exit(main())
