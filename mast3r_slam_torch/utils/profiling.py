"""Stage timing and traces (the port of
``mast3r_slam_tpu/utils/profiling.py``, and the port's own tracer).

* `StageTimer`: wall time accumulated per named stage; ``stage(name,
  sync_value=...)`` waits for the device before it stops the clock, so a
  stage whose work is still queued on the card is timed honestly.
* `trace`: a `torch.profiler` window over the CPU and, where there is one,
  the card, written as a Chrome trace (``trace.json``) under `log_dir`.
* `TRACER`, `span`, `traced`, `stage`: the process's tracer, switched on by
  ``runtime.trace`` for a `SLAM.run` (`Tracer.start` / `stop`). Off, `span`
  and `stage` hand out one shared null context and record nothing. On:

  - host spans at each layer boundary, on `time.perf_counter_ns`, kept in
    memory: name, start, end, parent span, window id and frame ids
    (inherited from the enclosing span), attributes;
  - per-frame timestamps (`mark`: taken, dispatched, drained, committed)
    and counters (`count`);
  - device stamps: inside a tracking window (`window`) on the card, each
    `stage` boundary and the window's two ends launch a one-thread kernel
    (``csrc/trace_stamp.cu``) that writes ``%globaltimer``. Captured into a
    window graph they are kernel nodes that fire on every replay. Each
    traced window takes the next row of a store in pinned, mapped host
    memory, picked by a device counter at the window's first stamp, so the
    kernels write the host's memory directly: no copy is queued and no
    host read is added; a window's row is complete once its drain's read
    returns (that read waits for the window), and every row after `stop`.
    The host keeps the rows' order (a row is registered when an eager
    window starts and when a traced graph is replayed, in stream order)
    and each row's labels (stage name, frame slot, begin or end), which a
    graph records once, at its capture;
  - one clock: `start` and `stop` each take a calibration pair (a clock
    kernel between two host reads around a synchronisation, the best of a
    few), which maps globaltimer onto `perf_counter_ns` with the pair's
    uncertainty (half its round trip) and the drift between the two pairs.

  While a torch.profiler session is active, `span` and `stage` also open a
  ``record_function`` of their name, on or off, so a profile keeps its
  annotations. `chrome` / `write_chrome` export host spans, device stages
  and per-frame spans on one clock, loadable in Perfetto.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import os
import threading
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler


def _wait(value) -> None:
    """Block until the device work behind `value` is done: every CUDA tensor
    among its leaves (tensor, sequence or dict) is waited for through a
    synchronisation of the card; CPU values need nothing."""
    if isinstance(value, dict):
        value = list(value.values())
    leaves = value if isinstance(value, (list, tuple)) else [value]
    if any(torch.is_tensor(x) and x.is_cuda for x in leaves):
        torch.cuda.synchronize()


class StageTimer:
    """Accumulates wall time per named stage. Pass `sync_value` (the stage's
    result) for a stage whose device work runs asynchronously."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                _wait(sync_value)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1e-12
        lines = [f"{'stage':<28}{'total s':>10}{'calls':>8}{'ms/call':>10}{'%':>6}"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            c = self.counts[name]
            lines.append(f"{name:<28}{t:>10.3f}{c:>8}{t / c * 1e3:>10.2f}{t / total * 100:>6.1f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: str = "build/trace"):
    """`torch.profiler` over the block (CPU activities, and CUDA where a card
    is present); on exit the Chrome trace goes to ``<log_dir>/trace.json``.
    Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ------------------------------------------------------------------ tracer

_NULL = contextlib.nullcontext()
WINDOW_BEGIN, WINDOW_END = "window.begin", "window.end"


@dataclass
class Span:
    """One host span; times in `perf_counter_ns`."""

    name: str
    t0: int
    t1: Optional[int] = None
    parent: Optional[int] = None  # index of the enclosing span in `Tracer.spans`
    window: Optional[int] = None
    frames: Optional[tuple] = None
    attrs: dict = field(default_factory=dict)
    thread: int = 0


@dataclass
class Row:
    """One traced window's stamps: `labels` [(name, frame slot, edge)] (edge 0
    begin, 1 end; slot None for the window's own ends), shared by every
    replay of one graph; the row's index in the store is its order."""

    labels: list
    window: Optional[int]
    frames: Optional[tuple]


@dataclass
class Calibration:
    """A clock pair: globaltimer `device_ns` read between host reads whose
    midpoint is `host_ns`; `half_rtt_ns` bounds the error."""

    device_ns: int
    host_ns: int
    half_rtt_ns: float


def _stamp_lib():
    """The stamp library (``csrc/trace_stamp.cu``), built on first use."""
    from mast3r_slam_torch.ops import build

    lib = build.load("trace_stamp")
    if lib.trace_stamp.argtypes is None:
        lib.trace_stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.trace_stamp.restype = ctypes.c_int
        lib.trace_clock.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.trace_clock.restype = ctypes.c_int
        lib.trace_device_pointer.argtypes = [ctypes.c_void_p]
        lib.trace_device_pointer.restype = ctypes.c_void_p
    return lib


# Stamp kernels launched, by symbol: counted at each host launch, so a
# graph's at its capture; `graphs` adds them per replay as for every kernel.
launches = {"trace_stamp": 0}


class _Device:
    """The device side of the tracer on one card: the row store (pinned,
    mapped host memory, `ROWS` x `WIDTH` int64), the clock cell, and the
    device state [next row, current row] the stamps read. Allocated on the
    first `Tracer.start` on a card and kept for the process: captured graphs
    hold their addresses."""

    ROWS = 1024
    WIDTH = 512

    def __init__(self, device: torch.device):
        self.device = device
        self.lib = _stamp_lib()
        self.store = torch.zeros((self.ROWS, self.WIDTH), dtype=torch.int64, pin_memory=True)
        self.clock = torch.zeros(1, dtype=torch.int64, pin_memory=True)
        self.state = torch.zeros(2, dtype=torch.int32, device=device)
        self.store_dev = self._mapped(self.store)
        self.clock_dev = self._mapped(self.clock)

    def _mapped(self, t: torch.Tensor) -> int:
        ptr = self.lib.trace_device_pointer(t.data_ptr())
        if not ptr:
            raise RuntimeError("trace: pinned memory is not mapped into the card's address space")
        return ptr

    @staticmethod
    def capturing() -> bool:
        return torch.cuda.is_current_stream_capturing()

    def stamp(self, slot: int, begin: bool) -> None:
        if slot >= self.WIDTH:
            raise RuntimeError(f"trace: a window with more than {self.WIDTH} stamps")
        err = self.lib.trace_stamp(torch.cuda.current_stream(self.device).cuda_stream,
                                   self.store_dev, self.state.data_ptr(), slot, self.WIDTH,
                                   self.ROWS, int(begin))
        if err != 0:
            raise RuntimeError(f"trace_stamp failed: cudaError {err}")
        launches["trace_stamp"] += 1

    def reset(self) -> None:
        torch.cuda.synchronize(self.device)
        self.store.zero_()
        self.state.zero_()

    def calibrate(self, tries: int = 5) -> Calibration:
        """The best of `tries` clock pairs (the shortest round trip)."""
        best = None
        stream = torch.cuda.current_stream(self.device)
        for _ in range(tries):
            torch.cuda.synchronize(self.device)
            a = time.perf_counter_ns()
            err = self.lib.trace_clock(stream.cuda_stream, self.clock_dev)
            if err != 0:
                raise RuntimeError(f"trace_clock failed: cudaError {err}")
            stream.synchronize()
            b = time.perf_counter_ns()
            pair = Calibration(int(self.clock[0]), (a + b) // 2, (b - a) / 2)
            if best is None or pair.half_rtt_ns < best.half_rtt_ns:
                best = pair
        return best


class _Span:
    """`span`'s context: a host span while the tracer is on, a
    ``record_function`` while a profiler session is active."""

    __slots__ = ("tracer", "name", "attrs", "index", "rf")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self.index = self.rf = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if self.tracer.on:
            self.index = self.tracer._open(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        if self.index is not None:
            self.tracer._close(self.index)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _Stage(_Span):
    """`stage`'s context: a span, and inside a window on the card a device
    stamp at each end."""

    __slots__ = ()

    def __enter__(self):
        super().__enter__()
        self.tracer._stamp(self.name, 0)
        return self

    def __exit__(self, *exc):
        self.tracer._stamp(self.name, 1)
        return super().__exit__(*exc)


class Tracer:
    """The port's tracer (module docstring). One per process: `TRACER`."""

    def __init__(self):
        self.on = False
        self._devices: dict = {}  # torch.device -> _Device, kept for the process
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        """Drop what was recorded (the device store is kept)."""
        self.spans: list[Span] = []
        self.counters: Counter = Counter()
        self.frames: dict[int, dict[str, int]] = {}
        self.rows: list[Row] = []
        self.calibration: list[Calibration] = []
        self.device: Optional[_Device] = None
        self._labels: Optional[list] = None  # the open window's labels
        self._capture_labels: list = []
        self._capturing = False
        self._windows = 0
        self.slot: Optional[int] = None  # the frame slot of the window's step

    # -------------------------------------------------------- on and off

    def start(self, device=None) -> None:
        """Reset and switch on; on a card, also the device stamps and the
        first calibration pair (a synchronisation)."""
        self.reset()
        device = torch.device(device) if device is not None else None
        if device is not None and device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            dev = self._devices.get(device)
            if dev is None:
                dev = self._devices[device] = _Device(device)
            dev.reset()
            self.device = dev
            self.calibration.append(dev.calibrate())
        self.on = True

    def stop(self) -> None:
        """Switch off; on a card, the second calibration pair, after which
        every row is complete."""
        if self.on and self.device is not None:
            self.calibration.append(self.device.calibrate())
            self.counters["trace.rows_dropped"] = max(0, len(self.rows) - len(self.device.store))
        self.on = False

    @contextlib.contextmanager
    def running(self, device=None, on: bool = True):
        """`start` on entry and `stop` on exit, if `on`."""
        if not on:
            yield
            return
        self.start(device)
        try:
            yield
        finally:
            self.stop()

    # ------------------------------------------------------- host record

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, name: str, attrs: dict) -> int:
        stack = self._stack()
        parent = stack[-1] if stack else None
        window = attrs.pop("window", None)
        frames = attrs.pop("frames", None)
        if parent is not None:
            p = self.spans[parent]
            window = p.window if window is None else window
            frames = p.frames if frames is None else frames
        self.spans.append(Span(name, time.perf_counter_ns(), None, parent, window,
                               None if frames is None else tuple(frames), attrs,
                               threading.get_ident()))
        stack.append(len(self.spans) - 1)
        return stack[-1]

    def _close(self, index: int) -> None:
        self.spans[index].t1 = time.perf_counter_ns()
        stack = self._stack()
        if stack and stack[-1] == index:
            stack.pop()

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            self.counters[name] += n

    def mark(self, frame_ids, event: str) -> None:
        """Stamp `event` (taken, dispatched, drained, committed) on each frame
        id, now."""
        if not self.on:
            return
        now = time.perf_counter_ns()
        for fid in frame_ids:
            self.frames.setdefault(int(fid), {})[event] = now

    def next_window(self) -> Optional[int]:
        """A new window id (None while off); counts ``tracker.windows``."""
        if not self.on:
            return None
        self._windows += 1
        self.counters["tracker.windows"] += 1
        return self._windows

    def context(self) -> tuple:
        """(window id, frame ids) of the innermost open span."""
        stack = self._stack()
        if not stack:
            return None, None
        s = self.spans[stack[-1]]
        return s.window, s.frames

    # ----------------------------------------------------- device stamps

    def _stamp(self, name: str, edge: int) -> None:
        labels = self._labels
        if labels is None:
            return
        labels.append((name, None if name in (WINDOW_BEGIN, WINDOW_END) else self.slot, edge))
        self.device.stamp(len(labels) - 1, name == WINDOW_BEGIN)
        if not self._capturing:
            self.counters["trace.stamps"] += 1

    def window(self):
        """A tracking window's program: on the card, its ``window.begin`` and
        ``window.end`` stamps and every `stage` stamp inside it; a new row
        for an eager window (a capture's labels go to `capture`). The shared
        null context while off, off the card, or inside another window."""
        if not (self.on and self.device is not None) or self._labels is not None:
            return _NULL
        return self._window()

    @contextlib.contextmanager
    def _window(self):
        self.slot = None
        self._capturing = self.device.capturing()
        if self._capturing:
            labels = self._capture_labels
        else:
            labels = []
            self.rows.append(Row(labels, *self.context()))
        self._labels = labels
        try:
            self._stamp(WINDOW_BEGIN, 0)
            yield
            self._stamp(WINDOW_END, 1)
        finally:
            self._labels, self._capturing, self.slot = None, False, None

    @contextlib.contextmanager
    def capture(self):
        """Around a window graph's capture: yields the list that receives the
        labels its stamps record (empty while off)."""
        self._capture_labels: list = []
        try:
            yield self._capture_labels
        finally:
            self._capture_labels = []

    def replayed(self, labels: list) -> None:
        """A traced graph (its `labels`) was replayed: its stamps fill the
        next row (nothing is kept while the tracer is off)."""
        if self.on:
            self.rows.append(Row(labels, *self.context()))
            self.counters["trace.stamps"] += len(labels)

    # ----------------------------------------------------------- results

    def to_host_ns(self, device_ns):
        """globaltimer ns -> `perf_counter_ns`, through the calibration pairs
        (a line through both, or an offset from one)."""
        c = self.calibration
        if not c:
            raise RuntimeError("trace: no calibration pair")
        a, b = c[0], c[-1]
        since = device_ns - a.device_ns  # in integers first: globaltimer is ~1e18 ns
        if b.device_ns == a.device_ns:
            return since + a.host_ns
        return a.host_ns + since * ((b.host_ns - a.host_ns) / (b.device_ns - a.device_ns))

    def clock(self) -> dict:
        """The calibration's uncertainty (the larger half round trip) and the
        drift between the pairs, in ns and per million."""
        c = self.calibration
        out = dict(pairs=len(c), uncertainty_ns=max((p.half_rtt_ns for p in c), default=None))
        if len(c) >= 2:
            drift = (c[-1].host_ns - c[-1].device_ns) - (c[0].host_ns - c[0].device_ns)
            out.update(drift_ns=drift, drift_ppm=1e6 * drift / max(1, c[-1].host_ns - c[0].host_ns))
        return out

    def device_rows(self) -> list[dict]:
        """Each traced window's row with its stamps on the host clock:
        dict(index, window, frames, stamps=[(name, slot, edge, host_ns)]).
        Rows beyond the store and stamps not (yet) written are left out;
        read after `stop`."""
        if self.device is None:
            return []
        store = self.device.store.numpy()
        out = []
        for i, row in enumerate(self.rows[:len(store)]):
            vals = store[i, :len(row.labels)]
            if len(vals) == 0 or not vals.all():
                continue
            host = self.to_host_ns(vals)
            out.append(dict(index=i, window=row.window, frames=row.frames,
                            stamps=[(*lab, float(t)) for lab, t in zip(row.labels, host)]))
        return out

    def chrome(self) -> dict:
        """Host spans, device stages, and frame spans (``frame.queued``:
        taken -> dispatched, ``frame.drain``: dispatched -> drained, the wait
        for the window's read, ``frame.inflight``: dispatched -> committed) as
        Chrome trace events on `perf_counter_ns` (µs), with the counters and
        the clock's figures under ``otherData``."""
        ev: list = [dict(ph="M", pid=pid, name="process_name", args=dict(name=name))
                    for pid, name in ((1, "host"), (2, "device"), (3, "frames"))]
        for i, s in enumerate(self.spans):
            if s.t1 is None:
                continue
            args = dict(id=i, parent=s.parent, window=s.window, frames=s.frames, **s.attrs)
            ev.append(dict(ph="X", pid=1, tid=s.thread, name=s.name, ts=s.t0 / 1e3,
                           dur=(s.t1 - s.t0) / 1e3, args=args))
        for row in self.device_rows():
            open_: dict = {}
            for name, slot, edge, t in row["stamps"]:
                if edge == 0:
                    open_[(name, slot)] = t
                    continue
                t0 = open_.pop((WINDOW_BEGIN if name == WINDOW_END else name, slot), None)
                if t0 is None:
                    continue
                frame = (row["frames"][slot] if row["frames"] is not None and slot is not None
                         and slot < len(row["frames"]) else None)
                ev.append(dict(ph="X", pid=2, tid=0 if slot is None else 1,
                               name="window" if name == WINDOW_END else name, ts=t0 / 1e3,
                               dur=(t - t0) / 1e3, args=dict(window=row["window"], slot=slot,
                                                             frame=frame, row=row["index"])))
        for fid, marks in sorted(self.frames.items()):
            for name, a, b in (("frame.queued", "taken", "dispatched"),
                               ("frame.drain", "dispatched", "drained"),
                               ("frame.inflight", "dispatched", "committed")):
                if a in marks and b in marks:
                    ev.append(dict(ph="b", cat="frame", id=fid, pid=3, tid=0, name=name,
                                   ts=marks[a] / 1e3, args=dict(frame=fid)))
                    ev.append(dict(ph="e", cat="frame", id=fid, pid=3, tid=0, name=name,
                                   ts=marks[b] / 1e3))
        return dict(traceEvents=ev, displayTimeUnit="ms",
                    otherData=dict(clock="perf_counter_ns", counters=dict(self.counters),
                                   calibration=self.clock()))

    def write_chrome(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome(), f)


def stage_ns(stamps: list) -> dict[str, float]:
    """A row's stamps [(name, slot, edge, t)] -> each stage's time, its end
    stamp less its begin stamp, summed over the frame slots (the window's
    own two ends left out)."""
    opened: dict = {}
    total: dict[str, float] = {}
    for name, slot, edge, t in stamps:
        if name in (WINDOW_BEGIN, WINDOW_END):
            continue
        if edge == 0:
            opened[(name, slot)] = t
        elif (name, slot) in opened:
            total[name] = total.get(name, 0.0) + t - opened.pop((name, slot))
    return total


TRACER = Tracer()


def span(name: str, **attrs):
    """A host span of `name` (attributes: ``window``, ``frames`` and any
    other), or the shared null context while the tracer is off and no
    profiler session is active."""
    if not (TRACER.on or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Span(TRACER, name, attrs)


def traced(name: str):
    """A decorator: each call of the function inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def stage(name: str):
    """A tracking stage: `span` and, inside a traced window on the card, a
    device stamp at each end."""
    if not (TRACER.on or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Stage(TRACER, name, {})
