"""The drain's read (`FrameTracker.sync_chain`, `sync_window`) on the CPU.

* On the CPU there is no stream and no event: a dispatched handle carries
  ``done`` None, the drain is the plain read of the handles' stats, one a
  drain (``tracker.drain_reads`` equals ``tracker.windows`` in a
  `SLAM.run`), and ``tracker.dispatch_ahead`` is never counted.
* The card's control flow, with stand-ins for CUDA's events and streams:
  each dispatch records its window's completion event on the current
  stream; the drain makes its side stream wait for every handle's event and
  reads there; ``tracker.dispatch_ahead`` counts a dispatch whose previous
  window's event has not fired (a query, made only while the tracer is on).
On a card: tests/test_torch_drain_cuda.py.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from mast3r_slam_torch.config import Config, reset_config, set_config
from mast3r_slam_torch.utils.profiling import TRACER
from mast3r_slam_torch.workload import BENCH_SETTINGS


@pytest.fixture
def tracer():
    TRACER.stop()
    TRACER.reset()
    yield TRACER
    TRACER.stop()
    TRACER.reset()


def _frames(n: int, hw=(48, 64), seed: int = 0) -> list:
    from mast3r_slam_torch.workload import drift_frames

    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, hw + (3,)).astype(np.float32)
    return list((drift_frames(base, n, rng) * 255).astype(np.uint8))


def _tiny_tracker():
    from mast3r_slam_torch.models import MASt3RModel
    from mast3r_slam_torch.tracker import FrameTracker

    cfg = set_config(Config.from_dict(BENCH_SETTINGS))
    model = MASt3RModel.create(model_type="tiny", resolution=64, device="cpu")
    return FrameTracker(model, cfg, device="cpu"), model


def test_cpu_slam_run_drains_with_the_plain_read(tracer, monkeypatch):
    """`SLAM.run` of the tiny model over 9 frames in windows of 2, traced:
    every handle carries no event, each drain returns exactly its handles'
    stats, one read a window, and no dispatch is counted ahead."""
    from mast3r_slam_torch.dataloader import Dataset
    from mast3r_slam_torch.models import MASt3RModel
    from mast3r_slam_torch.slam import SLAM
    from mast3r_slam_torch.tracker import FrameTracker

    imgs = _frames(9)

    class Frames(Dataset):
        def __len__(self):
            return len(imgs)

        def __getitem__(self, i):
            return float(i), imgs[i]

    sync_chain, reads = FrameTracker.sync_chain, []

    def drain(tracker, handles):
        stats = sync_chain(tracker, handles)
        reads.append(([h["done"] for h in handles], stats,
                      torch.stack([h["out"]["stats"] for h in handles]).numpy()))
        return stats

    monkeypatch.setattr(FrameTracker, "sync_chain", drain)
    settings = copy.deepcopy(BENCH_SETTINGS)
    settings["runtime"].update(sync_every=2, pipeline=True, trace=True)
    try:
        set_config(Config.from_dict(settings))
        model = MASt3RModel.create(model_type="tiny", resolution=64, device="cpu")
        slam = SLAM(model=model, resolution=64, device="cpu")
        slam.run(Frames())
    finally:
        reset_config()
    assert reads and slam.events["chained_step"] == len(imgs) - 1
    for done, got, held in reads:
        assert done == [None] * len(done)
        np.testing.assert_array_equal(got, held)
    c = tracer.counters
    assert c["tracker.drain_reads"] == c["tracker.windows"] == len(reads)
    assert "tracker.dispatch_ahead" not in c


def test_cpu_sync_window_is_the_plain_read(tracer):
    """`track_window` on the CPU leaves no event; `sync_window` reads the
    window's stats as they are; nothing is counted ahead."""
    try:
        tracker, model = _tiny_tracker()
        imgs = _frames(5, model.out_hw)
        tracker.init_keyframe(imgs[0])
        tracer.start()
        results = [tracker.track_window(np.stack(imgs[a:a + 2])) for a in (1, 3)]
        stats = [tracker.sync_window(r) for r in results]
        tracer.stop()
    finally:
        reset_config()
    for r, s in zip(results, stats):
        assert r["done"] is None
        np.testing.assert_array_equal(s, r["stats"].numpy())
    assert tracer.counters["tracker.drain_reads"] == tracer.counters["tracker.windows"] == 2
    assert "tracker.dispatch_ahead" not in tracer.counters


class _Card:
    """Stand-ins for ``torch.cuda``'s Event, Stream, stream and
    current_stream that log what the tracker asks of them."""

    def __init__(self):
        self.log: list = []
        self.fired: dict = {}  # event number -> what query() answers
        card = self

        class Event:
            def __init__(self):
                self.n = len(card.fired)
                card.fired[self.n] = False

            def record(self, stream):
                card.log.append(("record", self.n, stream))

            def query(self):
                card.log.append(("query", self.n))
                return card.fired[self.n]

        class Stream:
            def __init__(self, device):
                card.log.append(("new stream", str(device)))

            def wait_event(self, ev):
                card.log.append(("wait", ev.n))

        @contextlib.contextmanager
        def stream(s):
            card.log.append(("enter", type(s).__name__))
            yield
            card.log.append(("exit", type(s).__name__))

        self.Event, self.Stream, self.stream = Event, Stream, stream
        self.current_stream = lambda device=None: "main"

    def install(self, monkeypatch) -> None:
        for name in ("Event", "Stream", "stream", "current_stream"):
            monkeypatch.setattr(torch.cuda, name, getattr(self, name))


def test_card_drain_waits_on_each_windows_event_on_its_side_stream(tracer, monkeypatch):
    """On a card (stand-ins): each window's event is recorded on the current
    stream; the drain makes the tracker's one side stream wait for every
    handle's event, then stacks and reads inside it, and returns the
    handles' stats."""
    try:
        tracker, _model = _tiny_tracker()
    finally:
        reset_config()
    card = _Card()
    card.install(monkeypatch)
    tracker.device = torch.device("cuda")
    done = [tracker._window_done() for _ in range(3)]
    assert [e for e in card.log if e[0] == "record"] == [("record", n, "main") for n in range(3)]
    assert not [e for e in card.log if e[0] == "query"]  # the tracer is off: no query
    stats = [torch.full((2, 6), float(j)) for j in range(3)]
    handles = [dict(out=dict(stats=s), done=d) for s, d in zip(stats, done)]
    card.log.clear()
    got = tracker.sync_chain(handles[:2])
    assert card.log == [("new stream", "cuda"), ("wait", 0), ("wait", 1), ("enter", "Stream"),
                        ("exit", "Stream")]
    np.testing.assert_array_equal(got, torch.stack(stats[:2]).numpy())
    card.log.clear()
    np.testing.assert_array_equal(tracker.sync_window(dict(stats=stats[2], done=done[2])),
                                  stats[2].numpy())
    assert card.log == [("wait", 2), ("enter", "Stream"), ("exit", "Stream")]  # the same stream


@pytest.mark.parametrize("fired", [False, True])
def test_dispatch_ahead_counts_a_window_queued_behind_a_running_one(tracer, monkeypatch, fired):
    """``tracker.dispatch_ahead`` counts a dispatch whose previous window's
    event had not fired when the new window was queued; the first window
    has no previous one."""
    try:
        tracker, _model = _tiny_tracker()
    finally:
        reset_config()
    card = _Card()
    card.install(monkeypatch)
    tracker.device = torch.device("cuda")
    tracer.start()
    tracker._window_done()
    assert not [e for e in card.log if e[0] == "query"]
    card.fired[0] = fired
    tracker._window_done()
    tracer.stop()
    assert ("query", 0) in card.log
    assert tracer.counters["tracker.dispatch_ahead"] == (0 if fired else 1)
