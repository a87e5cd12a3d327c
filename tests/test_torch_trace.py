"""The port's tracer (`mast3r_slam_torch.utils.profiling`) and the readers of
the benchmark that take it (`slam_bench.program_trace`, the eleven
``slam_bench/metrics`` files it feeds), on the CPU.

* Off, `span`, `stage` and `window` hand out one shared null context and
  nothing is recorded.
* Host spans: parent, window and frame ids inherited through nesting; self
  time; the Chrome export's events.
* The clock: globaltimer mapped onto the host clock through one or two
  calibration pairs, with their uncertainty and drift.
* Device stamps: `FakeCard` does on the host what ``csrc/trace_stamp.cu``
  does on the card (a row per window from a counter, a slot per stamp), so
  a window of the tiny model through `FrameTracker.dispatch_window` gives its
  row layout: window.begin, K frames x six stages x (begin, end),
  window.end.
* Every reader on a synthetic trace whose answers are known.
* `SLAM.run` with ``runtime.trace`` on gives the poses and events of a run
  with it off, and every committed frame carries its four timestamps.
On a card: tests/test_torch_trace_cuda.py.
"""

import copy
import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mast3r_slam_torch.config import Config, reset_config, set_config
from mast3r_slam_torch.utils import profiling
from mast3r_slam_torch.utils.profiling import (TRACER, WINDOW_BEGIN, WINDOW_END, Calibration,
                                               Row, Span, Tracer, span, stage)
from mast3r_slam_torch.workload import BENCH_SETTINGS
from slam_bench import manifest, program_trace
from slam_bench.record import p90
from test_torch_window_graph_cuda import dispatch

STAGES = ("track.encode", "track.decode", "track.match", "track.pose", "track.fuse",
          "track.promote")


class FakeCard:
    """The stamp kernel's arithmetic on the host: a row per window from a
    counter, globaltimer a clock that advances `tick` ns per stamp."""

    def __init__(self, rows: int = 16, width: int = 128, t0: int = 10 ** 18, tick: int = 1000):
        self.store = torch.zeros((rows, width), dtype=torch.int64)
        self.next_row = self.row = 0
        self.t, self.tick = t0, tick
        self.pairs = [Calibration(t0, 5 * 10 ** 9, 1500.0)]

    @staticmethod
    def capturing() -> bool:
        return False

    def stamp(self, slot: int, begin: bool) -> None:
        self.t += self.tick
        if begin:
            self.row, self.next_row = self.next_row, self.next_row + 1
        if self.row < len(self.store):
            self.store[self.row, slot] = self.t

    def calibrate(self) -> Calibration:
        return self.pairs.pop(0) if self.pairs else Calibration(self.t, 5 * 10 ** 9 + self.t
                                                                 - 10 ** 18, 2000.0)


@pytest.fixture
def tracer():
    """The process's tracer, reset and switched off after the test."""
    yield TRACER
    TRACER.stop()
    TRACER.reset()


def test_off_records_nothing_and_hands_out_one_null_context(tracer):
    assert not tracer.on
    assert span("slam.upload") is span("x", window=1) is stage("track.pose") is profiling._NULL
    assert tracer.window() is profiling._NULL
    with span("a"), stage("track.encode"):
        tracer.count("graph.replays")
        tracer.mark((1, 2), "taken")
    assert tracer.next_window() is None
    assert not tracer.spans and not tracer.counters and not tracer.frames and not tracer.rows


def test_nested_spans_carry_parent_window_and_frame_ids(tracer):
    tracer.start()
    with span("tracker.dispatch_window", window=tracer.next_window(), frames=(8, 9)):
        with span("tracker.prepare"):
            with span("graph.capture", shape=(2, 48, 64, 3)):
                pass
        with span("graph.replay"):
            pass
    with span("slam.drain_window", frames=(8,)):
        pass
    names = [s.name for s in tracer.spans]
    assert names == ["tracker.dispatch_window", "tracker.prepare", "graph.capture",
                     "graph.replay", "slam.drain_window"]
    parents = [s.parent for s in tracer.spans]
    assert parents == [None, 0, 1, 0, None]
    assert [s.window for s in tracer.spans] == [1, 1, 1, 1, None]
    assert [s.frames for s in tracer.spans] == [(8, 9)] * 4 + [(8,)]
    assert tracer.spans[2].attrs == {"shape": (2, 48, 64, 3)}
    assert all(s.t0 <= s.t1 for s in tracer.spans)
    assert tracer.counters["tracker.windows"] == 1


def test_self_time_is_the_span_less_its_children():
    spans = [Span("a", 0, 100), Span("b", 10, 30, parent=0), Span("c", 30, 50, parent=0),
             Span("d", 60, 70, parent=0), Span("e", 12, 20, parent=1)]
    segs = program_trace.self_segments(spans)

    def self_time(name):
        return sum(e - s for s, e, n in segs if n == name)

    assert self_time("a") == 100 - 40 - 10
    assert self_time("b") == 20 - 8
    assert self_time("e") == 8
    assert sum(e - s for s, e, _ in segs) == 100
    assert segs == sorted(segs) and all(a[1] <= b[0] for a, b in zip(segs, segs[1:]))


@pytest.mark.parametrize("pairs, device_ns, host_ns", [
    ([Calibration(1000, 50, 3.0)], 1500, 550),
    ([Calibration(1000, 50, 3.0), Calibration(1000 + 10 ** 9, 50 + 10 ** 9 + 2000, 5.0)],
     1000 + 5 * 10 ** 8, 50 + 5 * 10 ** 8 + 1000),
])
def test_calibration_maps_globaltimer_onto_the_host_clock(pairs, device_ns, host_ns):
    tr = Tracer()
    tr.calibration = pairs
    assert tr.to_host_ns(device_ns) == pytest.approx(host_ns, abs=1e-6)
    got = tr.to_host_ns(np.array([device_ns, pairs[0].device_ns], dtype=np.int64))
    np.testing.assert_allclose(got, [host_ns, pairs[0].host_ns])
    clock = tr.clock()
    assert clock["pairs"] == len(pairs)
    assert clock["uncertainty_ns"] == max(p.half_rtt_ns for p in pairs)
    if len(pairs) == 2:
        assert clock["drift_ns"] == 2000 and clock["drift_ppm"] == pytest.approx(2.0, rel=1e-5)
    with pytest.raises(RuntimeError, match="no calibration"):
        Tracer().to_host_ns(0)


def _tiny_tracker(k_frames: int):
    from mast3r_slam_torch.models import MASt3RModel
    from mast3r_slam_torch.tracker import FrameTracker
    from mast3r_slam_torch.workload import drift_frames

    cfg = set_config(Config.from_dict(BENCH_SETTINGS))
    model = MASt3RModel.create(model_type="tiny", resolution=64, device="cpu")
    h, w = model.out_hw
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    tracker = FrameTracker(model, cfg, device="cpu")
    tracker.init_keyframe(base)
    return tracker, torch.from_numpy(drift_frames(base, 2 * k_frames, rng))


def test_stamp_row_layout_is_k_frames_by_stages(tracer):
    """A window of K = 3 on a card (`FakeCard`): one row per window, its
    labels window.begin, then per frame each stage's begin and end in order,
    then window.end; the stamps are the clock's, in order."""
    k = 3
    try:
        tracker, imgs = _tiny_tracker(k)
        tracer.start()
        card = tracer.device = FakeCard()
        tracer.calibration = [card.calibrate()]
        for j in range(2):
            tracker.sync_chain([dispatch(tracker, imgs[j * k:(j + 1) * k], 1 + j * k)])
        tracer.stop()
    finally:
        reset_config()
    want = [(WINDOW_BEGIN, None, 0)]
    want += [(name, j, edge) for j in range(k) for name in STAGES for edge in (0, 1)]
    want += [(WINDOW_END, None, 1)]
    assert [r.labels for r in tracer.rows] == [want, want]
    assert [r.window for r in tracer.rows] == [1, 2]
    assert tracer.counters["trace.stamps"] == 2 * len(want) == 2 * (2 + 12 * k)
    rows = tracer.device_rows()
    assert [r["index"] for r in rows] == [0, 1]
    t = np.array([s[3] for r in rows for s in r["stamps"]])
    np.testing.assert_allclose(np.diff(t), 1000.0)  # one tick a stamp, through the offset
    win = program_trace.windows_of(rows)
    assert [w.frames for w in win] == [k, k]
    assert win[0].stages == {name: k * 1000.0 for name in STAGES}
    assert win[0].end - win[0].begin == (len(want) - 1) * 1000.0
    assert tracer.counters["tracker.drain_reads"] == 2


@pytest.mark.parametrize("on", [False, True])
def test_graph_cache_captures_any_inputs(tracer, monkeypatch, on):
    """`GraphCache.window` takes any program's inputs; traced, its
    ``graph.capture`` span carries the shape its caller gives, if any."""
    from mast3r_slam_torch import graphs

    monkeypatch.setattr(graphs, "WindowGraph", lambda cache, fn, inputs: ("graph", fn))
    if on:
        tracer.start()
    cache = graphs.GraphCache("cpu")
    assert cache.window("row", (), len, {"x": torch.zeros(3)}) == ("graph", len)
    assert cache.window("win", (), abs, {"imgs": torch.zeros(4, 2, 3, 3)},
                        shape=(4, 2, 3, 3)) == ("graph", abs)
    caps = [s.attrs["shape"] for s in tracer.spans if s.name == "graph.capture"]
    assert caps == ([None, (4, 2, 3, 3)] if on else [])
    assert tracer.counters["graph.captures"] == (2 if on else 0)


def test_rows_beyond_the_store_are_dropped_and_counted(tracer):
    tracer.start()
    card = tracer.device = FakeCard(rows=2)
    tracer.calibration = [card.calibrate()]
    for _ in range(3):
        with tracer.window():
            with stage("track.encode"):
                pass
    tracer.stop()
    assert len(tracer.rows) == 3 and tracer.counters["trace.rows_dropped"] == 1
    assert [r["index"] for r in tracer.device_rows()] == [0, 1]


def test_chrome_export_shape(tracer, tmp_path):
    tracer.start()
    card = tracer.device = FakeCard()
    tracer.calibration = [card.calibrate()]
    tracer.mark((4, 5), "taken")
    with span("tracker.dispatch_window", window=tracer.next_window(), frames=(4, 5)):
        tracer.mark((4, 5), "dispatched")
        with tracer.window():
            for j in range(2):
                tracer.slot = j
                with stage("track.pose"):
                    pass
    tracer.mark((4, 5), "drained")
    tracer.mark((4, 5), "committed")
    tracer.stop()
    path = tmp_path / "t.json"
    tracer.write_chrome(str(path))
    doc = json.loads(path.read_text())
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
    ev = doc["traceEvents"]
    assert {e["ph"] for e in ev} == {"M", "X", "b", "e"}
    host = [e for e in ev if e["ph"] == "X" and e["pid"] == 1]
    assert [e["name"] for e in host] == ["tracker.dispatch_window", "track.pose", "track.pose"]
    assert host[0]["args"]["frames"] == [4, 5] and host[1]["args"]["parent"] == 0
    dev = [e for e in ev if e["ph"] == "X" and e["pid"] == 2]
    assert sorted(e["name"] for e in dev) == ["track.pose", "track.pose", "window"]
    assert sorted(e["args"]["frame"] for e in dev if e["name"] == "track.pose") == [4, 5]
    assert all(e["dur"] == pytest.approx(1.0) for e in dev if e["name"] == "track.pose")
    frames = [e for e in ev if e["pid"] == 3]
    assert sorted((e["name"], e["ph"]) for e in frames if e.get("id") == 4) == [
        ("frame.drain", "b"), ("frame.drain", "e"), ("frame.inflight", "b"),
        ("frame.inflight", "e"), ("frame.queued", "b"), ("frame.queued", "e")]
    assert doc["otherData"]["counters"]["trace.stamps"] == 6
    assert doc["otherData"]["calibration"]["pairs"] == 2


# ------------------------------------------------------------- the readers

MS = 10 ** 6
T0 = 100 * 10 ** 9  # the window opens at 100 s on the host clock
STAGE_MS = {"track.encode": 1.0, "track.decode": 2.0, "track.match": 1.0, "track.pose": 3.0,
            "track.fuse": 0.5, "track.promote": 0.25}
K, PERIOD_MS, TAIL_MS = 2, 20.0, 0.1


def _synthetic_trace() -> tuple:
    """Four windows of K = 2 frames, one every 20 ms from 99.99 s (the first,
    set-up's, before the window opens at 100 s), each 2 x 7.75 ms of stages
    + 0.1 ms; host spans over the gaps; frames dispatched 5 ms after their
    window's start and committed 30 + 10 j ms later; a capture before."""
    tr = Tracer()
    tr.calibration = [Calibration(7 * 10 ** 17, 0, 400.0),
                      Calibration(7 * 10 ** 17 + 10 ** 12, 10 ** 12, 600.0)]
    n = 4
    store = torch.zeros((8, 64), dtype=torch.int64)
    tr.device = SimpleNamespace(store=store)
    begins = [T0 - 10 * MS + i * PERIOD_MS * MS for i in range(n)]
    for i, b in enumerate(begins):
        labels, stamps, t = [(WINDOW_BEGIN, None, 0)], [b], b
        for j in range(K):
            for name, ms in STAGE_MS.items():
                labels += [(name, j, 0), (name, j, 1)]
                stamps += [t, t + ms * MS]
                t += ms * MS
        labels.append((WINDOW_END, None, 1))
        stamps.append(t + TAIL_MS * MS)
        tr.rows.append(Row(labels, i + 1, (2 * i, 2 * i + 1)))
        store[i, :len(stamps)] = torch.tensor([7 * 10 ** 17 + int(s) for s in stamps])
    replay_ns = K * sum(STAGE_MS.values()) * MS + TAIL_MS * MS
    spans = []
    for i, b in enumerate(begins):
        end = b + replay_ns
        # the drain reads 2 ms after the replay starts and waits 3 ms; the
        # gap after the replay holds the drain's bookkeeping (60%), the
        # loader, and the next window's dispatch (its last 1.5 ms)
        spans.append(Span("tracker.drain_read", b + 2 * MS, b + 5 * MS))
        gap = PERIOD_MS * MS - replay_ns
        nxt = b + PERIOD_MS * MS
        spans.append(Span("slam.drain_window", end, end + 0.6 * gap))
        spans.append(Span("loader.wait", end + 0.6 * gap, nxt - 1.5 * MS))
        spans.append(Span("tracker.dispatch_window", b - 1.5 * MS, b))
    spans.append(Span("graph.capture", T0 - 4 * 10 ** 9, T0 - 1 * 10 ** 9))
    spans.append(Span("track.promote", T0 - 3 * 10 ** 9, T0 - 2 * 10 ** 9, parent=len(spans) - 1))
    spans.append(Span("graph.capture", T0 - 3 * 10 ** 9, T0 - 2 * 10 ** 9, parent=len(spans) - 1))
    spans.append(Span("graph.capture", T0 - 0.5 * 10 ** 9, T0 - 0.25 * 10 ** 9))
    tr.spans = spans
    for i, b in enumerate(begins):
        for j in range(K):
            fid = 2 * i + j
            tr.frames[fid] = dict(taken=b - 8 * MS, dispatched=b - 1.5 * MS,
                                  drained=b + 5 * MS, committed=b + (30 + 10 * fid) * MS)
    rec = SimpleNamespace(t0=T0 / 1e9, t_close=(T0 + 60 * MS) / 1e9)
    return tr, rec


def _expected() -> dict:
    replay = K * sum(STAGE_MS.values()) + TAIL_MS  # ms a window
    gap = PERIOD_MS - replay
    # windows 2-4 open inside [100 s, 100.06 s); their frames 2..7; committed
    # inside: frames whose commit (begin + 30 + 10 fid ms) is before 100.06 s
    begins = [-10 + i * PERIOD_MS for i in range(4)]
    inflight = [1.5 + 30 + 10 * (2 * i + j) for i in range(4) for j in range(K)
                if 0 <= begins[i] + 30 + 10 * (2 * i + j) < 60]
    return {
        "window.encode_ms_per_frame": 1.0, "window.decode_ms_per_frame": 2.0,
        "window.match_ms_per_frame": 1.0, "window.pose_ms_per_frame": 3.0,
        "window.fuse_ms_per_frame": 0.75, "window.replay_ms_per_frame": replay / K,
        "entry.window_gap_ms_per_frame": gap / K,
        "entry.drain_wait_ms_per_window": 3.0, "entry.dispatch_host_ms_per_window": 1.5,
        "entry.inflight_ms_p90": p90(inflight), "setup.capture_s": 3.25,
    }


def test_each_reader_on_a_synthetic_trace(monkeypatch):
    tr, rec = _synthetic_trace()
    monkeypatch.setattr(profiling, "TRACER", tr)
    want = _expected()
    assert set(want) == {n for n, _ in program_trace.METRICS}
    for name, value in want.items():
        assert manifest.reader(name).read(rec) == pytest.approx(value, rel=1e-9), name
    got = program_trace.of(rec)
    assert [w.frames for w in got.windows] == [K, K, K]
    gaps = got.gap_by_span()
    gap_ms = (PERIOD_MS - K * sum(STAGE_MS.values()) - TAIL_MS) * 2  # two gaps inside
    assert gaps["slam.drain_window"] == pytest.approx(0.6 * gap_ms)
    assert gaps["tracker.dispatch_window"] == pytest.approx(2 * 1.5)
    assert gaps["loader.wait"] == pytest.approx(0.4 * gap_ms - 2 * 1.5)
    assert sum(gaps.values()) == pytest.approx(gap_ms) and "none" not in gaps


@pytest.mark.parametrize("port", ["untraced", "without a tracer"])
def test_readers_read_nothing_from_an_untraced_run(monkeypatch, port):
    """An untraced run, and a port that has no tracer (the parent commit's,
    under the benchmark's files): every reader returns nothing, and none
    raises."""
    if port == "untraced":
        monkeypatch.setattr(profiling, "TRACER", Tracer())
    else:
        monkeypatch.setitem(sys.modules, "mast3r_slam_torch.utils.profiling", None)
    rec = SimpleNamespace(t0=1.0, t_close=2.0)
    for name, _unit in program_trace.METRICS:
        assert manifest.reader(name).read(rec) is None, name


def test_stamp_agreement_ties_the_profiler_clock_to_the_stamps():
    tr, rec = _synthetic_trace()
    reading = program_trace.read_tracer(tr, rec.t0 * 1e9, rec.t_close * 1e9)
    rows = tr.device_rows()
    skew = 3.7e12  # the profiler's clock ahead of perf_counter_ns
    events = [dict(ph="X", cat="user_annotation", name=s.name, ts=(s.t0 + skew) / 1e3,
                   dur=(s.t1 - s.t0) / 1e3) for s in tr.spans[4:12]]
    stamps = [t for r in rows[1:3] for *_, t in r["stamps"]]
    events += [dict(ph="X", cat="kernel", name="void (anonymous namespace)::stamp_kernel(...)",
                    ts=(t + skew + 2000) / 1e3, dur=1.0) for t in stamps]
    n, med, worst = program_trace.stamp_agreement(events, reading, rows)
    assert n == len(stamps) and med == pytest.approx(2.0) and worst == pytest.approx(2.0)


def test_profile_step_stage_tables(tmp_path):
    from mast3r_slam_torch.profile_step import stage_kernels, stage_table

    labels = [(WINDOW_BEGIN, None, 0), ("track.encode", 0, 0), ("track.encode", 0, 1),
              ("track.pose", 0, 0), ("track.pose", 0, 1), (WINDOW_END, None, 1)]
    rows = [dict(stamps=[(*lab, t) for lab, t in zip(labels, (0, 1e6, 3e6, 3e6, 7e6, 8e6))])]
    assert stage_table(rows, 2) == {"track.encode": 1.0, "track.pose": 2.0}
    kinds = ["stamp", "k", "stamp", "k", "k", "stamp", "stamp", "k", "k", "k", "stamp", "stamp"]
    events = [dict(ph="X", cat="kernel", ts=i, dur=1,
                   name="stamp_kernel" if kind == "stamp" else "gemm")
              for i, kind in enumerate(kinds)]
    path = tmp_path / "tr.json"
    path.write_text(json.dumps(dict(traceEvents=events)))
    assert stage_kernels(str(path), labels, 1) == {"track.encode": 2.0, "track.pose": 3.0}


def test_traced_runner_patches_and_restores_the_harness(monkeypatch):
    """Without a card the runner's `slam_bench.run` refuses as it does, and
    the runner leaves the manifest and the trace reader as they were."""
    from slam_bench import trace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell, load = manifest.cell, trace.load_events
    name = manifest.benchmark()["workloads"][0]["name"]
    assert program_trace.main(["--workload", name, "--seed", "3000000000", "--seconds", "1",
                               "--trace", "1"]) == 2
    assert manifest.cell is cell and trace.load_events is load


def test_slam_run_traced_matches_untraced(tracer):
    """`SLAM.run` of the tiny model over 7 frames in windows of 2: with
    ``runtime.trace`` on, the same poses and events as off; every committed
    frame carries taken <= dispatched <= drained <= committed; the spans of
    each layer are recorded, the drain reads counted."""
    from mast3r_slam_torch.dataloader import Dataset
    from mast3r_slam_torch.models import MASt3RModel
    from mast3r_slam_torch.slam import SLAM
    from test_torch_helpers import tiny_frames

    imgs = tiny_frames(7, 0, (48, 64))

    class Frames(Dataset):
        def __len__(self):
            return len(imgs)

        def __getitem__(self, i):
            return float(i), imgs[i]

    runs = {}
    try:
        for on in (False, True):
            settings = copy.deepcopy(BENCH_SETTINGS)
            settings["runtime"].update(sync_every=2, pipeline=True, trace=on)
            set_config(Config.from_dict(settings))
            model = MASt3RModel.create(model_type="tiny", resolution=64, device="cpu")
            slam = SLAM(model=model, resolution=64, device="cpu")
            runs[on] = (slam.run(Frames()), dict(slam.events))
    finally:
        reset_config()
    (off, ev_off), (on, ev_on) = runs[False], runs[True]
    np.testing.assert_array_equal(on["poses"], off["poses"])
    assert ev_on == ev_off and ev_on["chained_step"] > 0
    assert not tracer.on and sorted(tracer.frames) == list(range(7))
    for fid, m in tracer.frames.items():
        assert m["taken"] <= m["dispatched"] <= m["drained"] <= m["committed"], fid
    names = {s.name for s in tracer.spans}
    assert {"loader.wait", "slam.upload", "tracker.dispatch_window", "tracker.prepare",
            "tracker.drain_read", "slam.drain_window", "slam.bookkeep", "slam.backend",
            *STAGES} <= names
    assert tracer.counters["tracker.drain_reads"] == tracer.counters["tracker.windows"] > 0
    assert all(s.t1 is not None for s in tracer.spans)
