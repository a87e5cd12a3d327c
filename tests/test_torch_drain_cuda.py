"""The drain's read on an NVIDIA GPU (marked `cuda`: skipped without a card).
This file imports no JAX, so it runs on a card machine outside the
repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_drain_cuda.py

A window's stats read (`FrameTracker.sync_chain`) waits for that window's
completion event, not for what was queued on the stream after it. On phase 5's small bf16 model (chip_smoke.py), windows of K = 4 frames:

* the read of a window returns while a ``torch.cuda._sleep`` queued behind
  the window is still running, and reads what a read after a full
  synchronise reads (`dispatch_window`, and `dispatch`'s windows of one);
* `SLAM.run` over 32 drifting frames (7 full windows) gives bit-equal
  poses, events and per-frame stats to a run whose drain synchronises the
  card first (a patch of the test, not a setting of the port), with one
  host sync at the drain's read per drained read, and
  ``tracker.dispatch_ahead`` counting every window dispatched behind a
  running one;
* windows dispatched in the loop's order (dispatch n+1, drain n) take one
  host sync a window, at the drain's read, and nothing else;
* a drain that sends a frame into RELOC aborts the chain, and the window
  dispatched against the old state is read once more, once.

In the `SLAM.run` cases a ``torch.cuda._sleep`` of about 0.1 s follows each
window (the small model's replay takes a few ms, less than the host's work
between two windows), so that the windows outlast that work, as the main
path's do.
"""

import copy

import numpy as np
import pytest
import torch

K = 4
N_FRAMES = 8 * K  # the INIT batch (one sync step, K - 1 windows of one), then 7 full windows
SLEEP_CYCLES = 200_000_000  # ~0.1 s at the H100's clock


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _model():
    from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel

    small = MASt3RConfig(enc_embed_dim=128, enc_depth=2, enc_num_heads=2, dec_embed_dim=128,
                         dec_depth=2, dec_num_heads=2, head_type="dpt", dtype=torch.bfloat16)
    return MASt3RModel.create(cfg=small, resolution=64, seed=1, device="cuda")


def _frames(hw: tuple, n: int, seed: int = 1) -> np.ndarray:
    """[n, H, W, 3] uint8: a seeded image drifting 2 px per frame."""
    from mast3r_slam_torch.workload import drift_frames

    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, hw + (3,)).astype(np.float32)
    return (drift_frames(base, n, rng) * 255).astype(np.uint8)


def _config(trace: bool, tracking: dict | None = None, reloc: dict | None = None):
    """bench.py's settings, windows of K, the chained path, `runtime.trace`."""
    from mast3r_slam_torch.config import Config, set_config
    from mast3r_slam_torch.workload import BENCH_SETTINGS

    settings = copy.deepcopy(BENCH_SETTINGS)
    settings["runtime"].update(sync_every=K, pipeline=True, trace=trace)
    settings["tracking"].update(tracking or {})
    if reloc:
        settings["reloc"] = dict(reloc)
    return set_config(Config.from_dict(settings))


def _started_slam(model, u8: torch.Tensor):
    """A SLAM on the card whose arena holds frame 0 as its first keyframe."""
    from mast3r_slam_torch.frame import create_frame
    from mast3r_slam_torch.slam import SLAM

    slam = SLAM(model=model, device="cuda", resolution=64)
    slam._initialize_state(*model.out_hw)
    f0 = create_frame(0, u8[0])
    slam._process_init(f0)
    return slam, f0


@pytest.mark.cuda
@pytest.mark.parametrize("api", ["dispatch_window", "dispatch"])
def test_drain_returns_before_the_work_queued_after_its_window(api):
    """(a) The read of a window returns while device work queued after the
    window is still pending, and reads what a read after a full synchronise
    reads."""
    _skip_without_card()
    from mast3r_slam_torch.config import reset_config
    from mast3r_slam_torch.frame import create_frame

    model = _model()
    u8 = torch.from_numpy(_frames(model.out_hw, 1 + 2 * K)).cuda()
    try:
        _config(trace=False)
        slam, f0 = _started_slam(model, u8)
        tracker = slam.tracker

        def window(a):
            frames = [create_frame(i, u8[i]) for i in range(a, a + K)]
            if api == "dispatch_window":
                return [tracker.dispatch_window(frames, u8[a:a + K], T_init=f0.T_WC)]
            return [tracker.dispatch(f, T_init=f0.T_WC) for f in frames]

        tracker.sync_chain(window(1))  # captures the graph
        handles = window(1 + K)
        held = torch.cat([h["out"]["stats"] for h in handles])

        def read():
            return tracker.sync_chain(handles)

        torch.cuda._sleep(10 * SLEEP_CYCLES)  # behind the window
        after = torch.cuda.Event()
        after.record()
        stats = read()
        pending = not after.query()
        torch.cuda.synchronize()
        full = held.cpu().numpy()
    finally:
        reset_config()
    assert pending, f"{api}: the drain's read waited for the work queued after its window"
    np.testing.assert_array_equal(stats, full)


class _Run:
    """One traced `SLAM.run` over `u8` with a sleep behind every window.
    Records each drain's handles (a sequence number for those of
    `dispatch_window`), whether it came after the chain was aborted (the
    RELOC re-read), its stats and whether each handle's event had fired
    when it returned; each committed frame's stats row; the host syncs by
    site; the tracer's counters. `synchronise_first` makes every drain
    synchronise the card before it reads (the reference)."""

    def __init__(self, model, u8: np.ndarray, monkeypatch, synchronise_first: bool, **config):
        from mast3r_slam_torch.config import reset_config
        from mast3r_slam_torch.dataloader import Dataset
        from mast3r_slam_torch.profile_step import count_syncs
        from mast3r_slam_torch.slam import SLAM
        from mast3r_slam_torch.tracker import FrameTracker
        from mast3r_slam_torch.utils.profiling import TRACER

        class Frames(Dataset):
            def __len__(self):
                return len(u8)

            def __getitem__(self, i):
                return float(i), u8[i]

        self.reads, self.rows, self.dispatched = [], [], []
        run_window, sync_chain = FrameTracker._run_window, FrameTracker.sync_chain
        commit, dispatch_window = FrameTracker.commit_chain_frame, FrameTracker.dispatch_window

        def slow_window(tracker, *a, **kw):
            out = run_window(tracker, *a, **kw)
            torch.cuda._sleep(SLEEP_CYCLES)
            return out

        def drain(tracker, handles):
            if synchronise_first:
                torch.cuda.synchronize()
            reread = tracker._chain is None
            stats = sync_chain(tracker, handles)
            self.reads.append(([h.get("seq") for h in handles], reread, stats,
                               [h["done"].query() for h in handles]))
            return stats

        def committed(tracker, frame, row, stats_row, tracked=True):
            self.rows.append((frame.frame_id, np.array(stats_row), tracked))
            return commit(tracker, frame, row, stats_row, tracked)

        def dispatched(tracker, *a, **kw):
            handle = dispatch_window(tracker, *a, **kw)
            if handle is not None:
                handle["seq"] = len(self.dispatched)
                self.dispatched.append(handle["seq"])
            return handle

        monkeypatch.setattr(FrameTracker, "_run_window", slow_window)
        monkeypatch.setattr(FrameTracker, "sync_chain", drain)
        monkeypatch.setattr(FrameTracker, "commit_chain_frame", committed)
        monkeypatch.setattr(FrameTracker, "dispatch_window", dispatched)
        box = {}
        try:
            _config(trace=True, **config)
            slam = SLAM(model=model, device="cuda", resolution=64)
            self.syncs = count_syncs(lambda: box.update(res=slam.run(Frames())))
        finally:
            TRACER.stop()
            reset_config()
            monkeypatch.undo()
        self.results, self.events = box["res"], dict(slam.events)
        self.counters = dict(TRACER.counters)


@pytest.mark.cuda
def test_slam_run_matches_a_drain_behind_a_full_synchronise(monkeypatch):
    """(b) Bit-equal poses, events, keyframes and per-frame stats to a run
    whose drain synchronises the card first; (c) one host sync at the
    drain's read per drained read; (d) every window is dispatched behind a
    running one but two: the run's first window (none ran before it) and
    the first full window, which follows the read of the INIT batch's
    windows of one (a read that waits for the last of them)."""
    _skip_without_card()
    model = _model()
    u8 = _frames(model.out_hw, N_FRAMES)
    ref = _Run(model, u8, monkeypatch, synchronise_first=True)
    got = _Run(model, u8, monkeypatch, synchronise_first=False)

    np.testing.assert_array_equal(got.results["poses"], ref.results["poses"])
    assert got.results["keyframe_indices"] == ref.results["keyframe_indices"]
    assert got.events == ref.events and got.events["chained_step"] == N_FRAMES - 1
    assert got.events.get("chained_promotion", 0) == 0 and got.events.get("reloc", 0) == 0
    assert [(f, t) for f, _s, t in got.rows] == [(f, t) for f, _s, t in ref.rows]
    for (f, a, _t), (_f, b, _u) in zip(got.rows, ref.rows):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {f}")
    assert len(got.reads) == len(ref.reads)
    for (_h, _r, a, _d), (_i, _s, b, _e) in zip(got.reads, ref.reads):
        np.testing.assert_array_equal(a, b)
    assert all(all(fired) for _h, _r, _s, fired in got.reads)  # each read waited for its windows

    c = got.counters
    full = len(got.dispatched)
    assert full == N_FRAMES // K - 1 >= 6
    assert c["tracker.windows"] == full + K - 1  # and the INIT batch's windows of one
    assert c["tracker.drain_reads"] == len(got.reads) == full + 1
    drain_site = [s for s in got.syncs if s.startswith("mast3r_slam_torch/tracker.py")]
    assert len(drain_site) == 1, got.syncs
    assert got.syncs[drain_site[0]] == c["tracker.drain_reads"], got.syncs
    assert c["tracker.dispatch_ahead"] == c["tracker.windows"] - 2, c
    # behind a full synchronise only the INIT batch's later windows of one and
    # the second full window (dispatched before the first is drained) run ahead
    assert ref.counters["tracker.dispatch_ahead"] == K - 1, ref.counters


@pytest.mark.cuda
def test_windows_in_the_loop_order_take_one_host_sync_each():
    """(c) Windows dispatched in `SLAM.run`'s order (dispatch n+1, then drain
    n) read the host once a window, at the drain's read, and nothing else
    synchronises."""
    _skip_without_card()
    from mast3r_slam_torch.config import reset_config
    from mast3r_slam_torch.frame import create_frame
    from mast3r_slam_torch.profile_step import count_syncs

    model = _model()
    n = 6
    u8 = torch.from_numpy(_frames(model.out_hw, 1 + (n + 1) * K)).cuda()
    try:
        _config(trace=False)
        slam, f0 = _started_slam(model, u8)
        tracker = slam.tracker

        def window(j):
            a = 1 + j * K
            return tracker.dispatch_window([create_frame(i, u8[i]) for i in range(a, a + K)],
                                           u8[a:a + K], T_init=f0.T_WC)

        tracker.sync_chain([window(0)])  # captures the graph

        def loop():
            prev = window(1)
            for j in range(2, n + 1):
                cur = window(j)
                tracker.sync_chain([prev])
                prev = cur
            tracker.sync_chain([prev])

        syncs = count_syncs(loop)
    finally:
        reset_config()
    assert len(syncs) == 1 and next(iter(syncs)).startswith("mast3r_slam_torch/tracker.py"), syncs
    assert sum(syncs.values()) == n, syncs


@pytest.mark.cuda
def test_reloc_abort_rereads_the_dispatched_window_once(monkeypatch):
    """(e) With `min_match_frac` 1.01 every tracked frame skips into RELOC
    (`reloc.min_match_frac` 0, so that relocalisation succeeds): a drain
    that aborts the chain makes the loop read the window dispatched just
    before it once more, after its completion; no window is read twice; the
    run equals one whose drain synchronises first."""
    _skip_without_card()
    model = _model()
    u8 = _frames(model.out_hw, 4 * K)
    config = dict(tracking={"min_match_frac": 1.01}, reloc={"min_match_frac": 0.0})
    ref = _Run(model, u8, monkeypatch, synchronise_first=True, **config)
    got = _Run(model, u8, monkeypatch, synchronise_first=False, **config)

    rereads = [r for r in got.reads if r[1]]
    assert rereads and got.events["reloc"] > 0
    for seqs, _r, _s, fired in rereads:
        assert len(seqs) == 1 and seqs[0] in got.dispatched and all(fired)
    read = [s for seqs, _r, _st, _f in got.reads for s in seqs if s is not None]
    assert sorted(read) == got.dispatched  # each window of K read once
    np.testing.assert_array_equal(got.results["poses"], ref.results["poses"])
    assert got.events == ref.events
    assert len(got.reads) == len(ref.reads)
    for (_h, _r, a, _d), (_i, _s, b, _e) in zip(got.reads, ref.reads):
        np.testing.assert_array_equal(a, b)
