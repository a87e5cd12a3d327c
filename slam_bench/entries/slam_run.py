"""Entry ``slam_run``: the port's `SLAM.run` over a seeded camera
stream, measured in its steady state.

Set-up builds the kernels (the first run in a checkout compiles them), the
model at the configuration's widths with the benchmark's weights
(`weights.make`), and a `SLAM`; then `SLAM.run` starts over an endless
`frames.DriftStream`. The loop's loader is wrapped (``StampedLoader``): it
stamps the host time at which the loop takes each frame, opens the window at
frame ``warmup_windows`` x K (everything before it, captures of the window
graphs and the first backend solves included, is set-up), and closes it at
the first frame request ``--seconds`` later. With ``--trace 1`` the next
``trace_windows`` windows after the close run under torch.profiler,
synchronised at both ends; then the loader ends and the loop drains.

The per-frame callback of `SLAM._bookkeep` stamps each commit. Wrapped
calls into the port record the rest: `FrameTracker.commit_chain_frame`
samples frames for the check (`sampler`), `FactorGraph.add_factors` logs its
keyframe pairs, and with ``--trace 1`` CUDA events time `dispatch_window`
and ``bench.*`` spans mark the loader, dispatch, drain, backend and
bookkeeping on the host. Once the run has ended, the program is freed and the plain
reference re-computes each sampled step (`check`).
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import tempfile
import time

import numpy as np

from slam_bench import check, cost, weights
from slam_bench.frames import DriftStream
from slam_bench.record import Record
from slam_bench.settings import settings_of
from slam_bench.syncs import SyncCounter
from slam_bench.trace import SLICE_SPAN, load_events, summarize


@contextlib.contextmanager
def patched(*triples):
    """Set (owner, attribute, value) for the block, then restore."""
    saved = [(o, a, getattr(o, a)) for o, a, _ in triples]
    for o, a, v in triples:
        setattr(o, a, v)
    try:
        yield
    finally:
        for o, a, v in saved:
            setattr(o, a, v)


def build_model(cell, seed: int, device, control: str | None = None):
    """The port's model at the configuration's widths, holding the
    benchmark's weights for `seed`."""
    import torch

    from mast3r_slam_torch.models.mast3r import MASt3RModel
    from slam_bench.reference.network import Net, NetSizes

    c = cell.config
    model = MASt3RModel.create(model_type=c["model_type"], variant=c["variant"],
                               resolution=c["resolution"], precision=c["precision"],
                               device=device, head_type=c["network"].get("head_type"))
    got = {k: getattr(model.cfg, k) for k in NetSizes.__dataclass_fields__
           if k not in ("gelu",) and hasattr(model.cfg, k)}
    want = {k: c["network"][k] for k in got}
    if got != want:
        raise ValueError(f"the port's {c['model_type']} has {got}, the configuration {want}")
    if tuple(model.out_hw) != (c["input"]["height"], c["input"]["width"]):
        raise ValueError(f"the port decodes at {model.out_hw}, the configuration {c['input']}")
    with torch.device("meta"):
        meta = Net(NetSizes.from_config({**c["network"], "gelu": c["gelu"]}))
    served = weights.make(meta, seed, device, c["precision"])
    params = dict(model.net.named_parameters())
    if set(params) != set(served) or any(
            params[k].shape != v.shape or params[k].dtype != v.dtype for k, v in served.items()):
        raise ValueError("the port's parameters differ from the benchmark's leaves")
    with torch.no_grad():
        for k, v in served.items():
            params[k].copy_(v)
    del served
    if control == "int8":  # the port's own lower-precision path: the check's control
        model.quantize_weights("int8")
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    return model


class Sampler:
    """A uniform sample (reservoir, seeded) of the frames committed in the
    window whose step started from a state the drained window shows: frames
    after the first of their window. For each, what the step produced and
    the state it started from, copied into host buffers (pinned on a card)
    that the first commit allocates, in set-up: the samples take nothing of
    the device's memory, and a copy joins the device's stream without a
    host read."""

    CUR = ("feat", "frame_X", "frame_C", "T_WCf", "ret_X")
    PREV = ("kf_X", "kf_C", "T_WCf", "kf_T")

    def __init__(self, size: int, seed: int):
        self.size, self.rng = size, np.random.default_rng([int(seed) % (1 << 64), 2])
        self.meta: list = []  # per filled slot: fid, kf_fid, stats, kN
        self.buf: dict = {}
        self.seen = 0
        self.prev = None  # (frame id, row, stats, window id, keyframe id after it)
        self.kf_id = 0
        self.window_id = 0

    def _alloc(self, row: dict) -> None:
        import torch

        pin = row["feat"].is_cuda
        self.buf = {f"{pre}{k}": torch.empty((self.size, *row[k].shape), dtype=row[k].dtype,
                                             pin_memory=pin)
                    for pre, keys in (("", self.CUR), ("p_", self.PREV)) for k in keys}

    def offer(self, fid: int, row: dict, stats, tracked: bool, open_: bool) -> None:
        from mast3r_slam_torch.tracker import EVENT_NEW_KF

        if not self.buf:
            self._alloc(row)
        prev, kf_before = self.prev, self.kf_id
        if int(round(float(stats[3]))) == EVENT_NEW_KF:
            self.kf_id = fid
        self.prev = (fid, row, np.array(stats), self.window_id, self.kf_id)
        if not (open_ and tracked and prev is not None and prev[0] == fid - 1
                and prev[3] == self.window_id):
            return
        self.seen += 1
        slot = len(self.meta) if len(self.meta) < self.size else int(
            self.rng.integers(0, self.seen))
        if slot >= self.size:
            return
        p_row, p_stats = prev[1], prev[2]
        for pre, src, keys in (("", row, self.CUR), ("p_", p_row, self.PREV)):
            for k in keys:
                self.buf[pre + k][slot].copy_(src[k], non_blocking=True)
        meta = dict(fid=fid, kf_fid=kf_before, stats=np.array(stats), kN=float(p_stats[4]))
        if slot < len(self.meta):
            self.meta[slot] = meta
        else:
            self.meta.append(meta)

    @property
    def samples(self) -> list:
        """The sample, once the device has finished its copies."""
        return [dict(m, **{k: b[i] for k, b in self.buf.items()}) for i, m in enumerate(self.meta)]


def run(cell, seed: int, seconds: float, trace: bool, t_proc: float,
        control: str | None = None, controls: bool = False,
        per_frame: bool = False) -> tuple[Record, dict]:
    """One run of `cell` -> (its record, the check's numbers). The port's
    own prints go to standard error. `control` puts the port's int8 path in
    the program's place; `controls` also reads the check's stage controls
    (`check.slam_steps`), and `per_frame` each sampled frame's pose
    readings. The benchmark's own runs take none of them."""
    import torch

    from mast3r_slam_torch import slam as slam_mod
    from mast3r_slam_torch.config import Config, set_config
    from mast3r_slam_torch.dataloader import Dataset, PrefetchLoader
    from mast3r_slam_torch.global_opt import FactorGraph
    from mast3r_slam_torch.ops import build
    from mast3r_slam_torch.tracker import FrameTracker

    dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    tr = cell.traffic
    set_config(Config.from_dict(settings_of(cell)))
    if dev.type == "cuda":
        build.build_all()
    model = build_model(cell, seed, dev, control)
    stream = DriftStream.from_traffic(seed, tr["frames"])
    k = int(settings_of(cell)["runtime"]["sync_every"])
    warm, slice_frames = tr["warmup_windows"] * k, (tr["trace_windows"] * k if trace else 0)
    rec = Record(seconds=seconds, trace=trace, t_proc=t_proc, shapes=cost.Shapes.from_config(
        cell.config))
    sampler = Sampler(cell.spec["sample_frames"], seed)
    syncs = SyncCounter(os.path.dirname(os.path.dirname(os.path.abspath(slam_mod.__file__))))
    pairs_log: list = []  # (host time, keyframe pairs) per backend decode
    slam = slam_mod.SLAM(model=model, device=dev, resolution=cell.config["resolution"])
    state = {"phase": "warmup"}

    def counts() -> dict:
        ev = slam.events
        return dict(step=ev["init"] + ev["chained_step"] + ev["sync_step"],
                    mono=ev["chained_promotion"] + ev["sync_promotion"] + ev["reloc"],
                    init=ev["init"], reloc=ev["reloc"], t=time.perf_counter())

    def delta(a: dict, b: dict) -> dict:
        d = {key: b[key] - a[key] for key in ("step", "mono", "init", "reloc")}
        d["step"] -= d["init"]
        d["backend_pairs"] = [p for t, p in pairs_log if a["t"] <= t < b["t"]]
        return d

    class Frames(Dataset):
        def __len__(self):
            return 10 ** 7

        def __getitem__(self, i):
            return stream.timestamp(i), stream.frame(i)

    marks: dict = {}
    prof_box: dict = {}

    def admit(i: int) -> bool:
        """Called as the loop asks for frame i; False ends the stream."""
        now = time.perf_counter()
        if state["phase"] == "warmup" and i == warm:
            rec.t0 = now
            marks["w0"] = counts()
            if trace:
                syncs.start()
            state["phase"] = "window"
        elif state["phase"] == "window" and now >= rec.t1:
            rec.t_close = now
            if dev.type == "cuda":
                rec.peak_bytes = torch.cuda.max_memory_allocated(dev)
            marks["w1"] = counts()
            rec.frames_in_close = i - warm
            if trace:
                syncs.stop()
                rec.syncs, rec.sync_sites = syncs.total, dict(syncs.sites)
            state["phase"] = "slice" if trace else "done"
            state["slice_at"] = -(-i // k) * k
        if state["phase"] == "slice":
            if i == state["slice_at"]:
                torch.cuda.synchronize()
                marks["s0"] = counts()
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                          torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                span = torch.profiler.record_function(SLICE_SPAN)
                span.__enter__()
                prof_box.update(prof=prof, span=span)
            elif i == state["slice_at"] + slice_frames:
                torch.cuda.synchronize()
                marks["s1"] = counts()
                prof_box["span"].__exit__(None, None, None)
                prof_box["prof"].__exit__(None, None, None)
                state["phase"] = "done"
        return state["phase"] != "done"

    class StampedLoader(PrefetchLoader):
        def __call__(self, max_frames=None):
            inner = PrefetchLoader.__call__(self, max_frames)
            i = 0
            while admit(i):
                with rec.span("bench.loader"):
                    item = next(inner, None)
                if item is None:
                    return
                rec.taken[i] = time.perf_counter()
                yield item
                i += 1

    def on_commit(frame, _keyframes) -> None:
        now = time.perf_counter()
        rec.commits.append((frame.frame_id, rec.taken.get(frame.frame_id, now), now))

    def spanned(fn, name):
        def wrapper(*a, **kw):
            with rec.span(name):
                return fn(*a, **kw)
        return wrapper

    ev_dispatch: list = []

    def dispatch_window(tracker, frames, *a, **kw):
        """In the window of a traced run, CUDA events on the current stream
        around the dispatch (the replay and its copies)."""
        if not (trace and state["phase"] == "window"):
            return orig_dispatch(tracker, frames, *a, **kw)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = orig_dispatch(tracker, frames, *a, **kw)
        e.record()
        ev_dispatch.append((s, e, len(frames)))
        return out

    orig_commit, orig_drain = FrameTracker.commit_chain_frame, slam_mod.SLAM._drain_window
    orig_add, orig_dispatch = FactorGraph.add_factors, FrameTracker.dispatch_window

    def commit(tracker, frame, row, stats_row, tracked=True):
        now = time.perf_counter()
        sampler.offer(frame.frame_id, row, stats_row, tracked,
                      rec.t0 is not None and rec.t0 <= now < rec.t1)
        return orig_commit(tracker, frame, row, stats_row, tracked)

    def drain(self_slam, *a, **kw):
        sampler.window_id += 1
        return orig_drain(self_slam, *a, **kw)

    def add_factors(fg, ii, jj, *a, **kw):
        pairs_log.append((time.perf_counter(), len(ii)))
        return orig_add(fg, ii, jj, *a, **kw)

    patches = [
        (slam_mod, "PrefetchLoader", StampedLoader),
        (FrameTracker, "commit_chain_frame", commit),
        (slam_mod.SLAM, "_drain_window", drain),
        (FactorGraph, "add_factors", add_factors),
        (FrameTracker, "dispatch_window", spanned(dispatch_window, "bench.dispatch_window")),
        (FrameTracker, "sync_chain", spanned(FrameTracker.sync_chain, "bench.drain")),
        (slam_mod.SLAM, "_run_backend", spanned(slam_mod.SLAM._run_backend, "bench.backend")),
        (slam_mod.SLAM, "_bookkeep", spanned(slam_mod.SLAM._bookkeep, "bench.bookkeep")),
    ]
    with patched(*patches), contextlib.redirect_stdout(sys.stderr):
        slam.run(Frames(), callback=on_commit)
    if rec.t0 is None or rec.t_close is None:
        raise RuntimeError(f"the stream ended in {state['phase']}: the window never closed")
    rec.events = delta(marks["w0"], marks["w1"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
        rec.dispatch = [(s.elapsed_time(e), n) for s, e, n in ev_dispatch]
    if trace and "s1" in marks:
        rec.slice_events = delta(marks["s0"], marks["s1"])
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof_box["prof"].export_chrome_trace(path)
            rec.summary = summarize(load_events(path), cost.ATTENTION_SYMBOL)
        finally:
            os.remove(path)
        prof_box.clear()
    samples = sampler.samples
    del slam, model, prof_box
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.slam_steps(cell, seed, samples, dev, controls, per_frame)
    return rec, numbers
