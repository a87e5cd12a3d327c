"""SLAM orchestration: the INIT / TRACKING / RELOC loop and its command line
(the port of ``mast3r_slam_tpu/slam.py``).

    python -m mast3r_slam_torch.slam <dataset dir or video> --max-frames N

`SLAM.run` consumes frames from the prefetching host loader in windows of
`runtime.sync_every`. With `runtime.pipeline` on, a TRACKING window goes
through the tracker's chained steps (`FrameTracker.dispatch_window`), whose
keyframe/skip decisions and promotions happen inside the steps, and a
TRACKING frame of a batch that is not a full window through a window of one
(`FrameTracker.dispatch`); INIT, RELOC and frames without the pipeline take
the synchronous per-frame path (`_step_sync`). After each frame the backend
drains its queue (`_run_backend`: symmetric matching of the new keyframe
against up to three before it, then a graph solve, calibrated with
`use_calib` and rays-mode otherwise); a full arena evicts its
lowest-covisibility keyframe (`_evict_if_full`).

Calibrated mode (`use_calib: true`): the arena's intrinsics K come from
`dataset.calib` (processed-image pixels, rescaled for `img_downsample`) or,
without it, from the first keyframe's mono pointmap
(`utils.intrinsics.estimate_intrinsics`, in `_process_init`); the tracker
and the backend then run the pixel + log-depth objectives.

Host and card (the counterpart of the JAX package's two side threads, which
hide a TPU link's round trip):

* Upload. Each window's uint8 frames are stacked once in pinned host memory
  and copied to the card with ``non_blocking=True``; window n+1's copy is
  queued before window n is processed, as the JAX uploader does.
* Drain. The loop has one drain (`drain` in `run`): one
  `FrameTracker.sync_chain` over the pending window handles, then their
  frames resolved in order (`_drain_window`). Window n's stats are read
  only after window n+1 has been dispatched (the JAX order), so their
  bookkeeping follows in strict window order; the windows of one of a
  batch's tail are drained together, before the next synchronous step and
  at the batch's end. The read waits for its own windows' completion
  events, not for window n+1: it returns when replay n ends, and the host
  drains n, loads, uploads and dispatches window n+2 while replay n+1
  runs, so the card goes from one replay to the next. If that drain sends
  a frame into RELOC, the chain is aborted and the window run against the
  old state is read once more and replayed synchronously.

Host reads per chained window: none inside it (on the card a window is one
replay of a captured CUDA graph, its promotions decided on the device,
tracker.py), one for the window's [K, 6] stats at the drain
(`FrameTracker.sync_chain`), and the backend's (one for the match fractions
of each `add_factors`, none inside a solve). Processing order, bookkeeping,
replay after a skip and the `refresh_chain` / `queue_arena_correction`
handshake are those of the JAX loop.

Run services, as in the JAX loop: `save_state` / `load_state` and a
snapshot every `runtime.snapshot_every` frames to `runtime.snapshot_path`
(`utils.snapshot`, JAX's file format); a JSON-lines record per frame and per
eviction to `runtime.metrics_path`, summarised at the end of `run`
(`utils.metrics`). A frame record takes the tracker's match statistics from
the window's one stats read, so metrics add no host read; a snapshot reads
the device state once (one wait per snapshot).

Tracing (`runtime.trace`): the run starts the port's tracer
(`utils.profiling.TRACER`) and stops it at its end; the loop stamps each
frame when it is taken from the loader, and `runtime.trace_path` receives
the Chrome trace. Spans: ``loader.wait``, ``slam.upload``,
``slam.drain_window`` with ``slam.bookkeep`` inside, ``slam.backend`` (one
a backend task), and the tracker's and graphs' own.

`runtime.weight_quant: int8` holds the model's large weights as int8
(`models.quant`); `runtime.viewer_port` serves the live viewer (`viewer`),
which reads the device only on the frames it publishes (a promotion, and
every `runtime.viewer_refresh` frames).
"""

from __future__ import annotations

import collections
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from mast3r_slam_torch.config import get_config, load_config, set_config
from mast3r_slam_torch.dataloader import Dataset, PrefetchLoader, load_dataset
from mast3r_slam_torch.device import resolve_device
from mast3r_slam_torch.frame import Frame, Keyframes, Mode, SLAMState, create_frame
from mast3r_slam_torch.global_opt import FactorGraph
from mast3r_slam_torch.inference import mast3r_inference_mono, mast3r_match_asymmetric
from mast3r_slam_torch.lie import core as lie
from mast3r_slam_torch.models.mast3r import load_mast3r
from mast3r_slam_torch.retrieval_db import RetrievalDatabase, load_retriever
from mast3r_slam_torch.tracker import EVENT_NEW_KF, EVENT_SKIP, FrameTracker
from mast3r_slam_torch.utils.export import save_ply, save_trajectory_kitti, save_trajectory_tum
from mast3r_slam_torch.utils.intrinsics import estimate_intrinsics
from mast3r_slam_torch.utils.metrics import MetricsLogger, summarize
from mast3r_slam_torch.utils.profiling import TRACER, span, traced
from mast3r_slam_torch.utils.snapshot import load_snapshot, save_snapshot
from mast3r_slam_torch.viewer import LiveViewer


class SLAM:
    """MASt3R-SLAM on one card (`device`, default the card, raising without
    CUDA; the model's device when a model is given)."""

    def __init__(self, config_path: Optional[str | Path] = None, model_type: str = "mast3r_full",
                 model_variant: str = "base", resolution: int = 512, precision: str = "bf16",
                 model=None, device=None, seed: int = 0):
        if config_path:
            load_config(config_path)
        self.config = get_config()
        if model is not None:
            self.model = model
            self.device = resolve_device(model.device if device is None else device)
        else:
            self.device = resolve_device(device)
            print(f"Loading {model_type} ({model_variant}, {resolution}px)...")
            self.model = load_mast3r(
                model_type=model_type, variant=model_variant, resolution=resolution,
                precision=precision, checkpoint=self.config.model.checkpoint,
                head_type=self.config.model.head_type, seed=seed, device=self.device,
                weight_quant=self.config.runtime.weight_quant,
            )
        # int8 weights (runtime.weight_quant, models.quant); idempotent, so a
        # model quantized by the caller or by load_mast3r is fine
        wq = self.config.runtime.weight_quant
        if wq != "none":
            if not hasattr(self.model, "quantize_weights"):
                raise ValueError(f"runtime.weight_quant={wq!r} needs a MASt3RModel; "
                                 f"got {type(self.model).__name__}")
            self.model.quantize_weights(wq)
        self.resolution = resolution
        self.keyframes: Optional[Keyframes] = None
        self.tracker: Optional[FrameTracker] = None
        self.factor_graph: Optional[FactorGraph] = None
        self.state: Optional[SLAMState] = None
        self.retrieval_db: Optional[RetrievalDatabase] = None
        self.timestamps: list[float] = []
        self.poses: list[torch.Tensor] = []
        self.metrics: Optional[MetricsLogger] = None  # with runtime.metrics_path
        self.viewer: Optional[LiveViewer] = None  # with runtime.viewer_port
        self._viewer_colors: dict[int, np.ndarray] = {}  # frame id -> subsampled rgb
        # What the network ran, by event (an init, a chained or synchronous
        # tracking step, a promotion, a reloc's mono decode, a symmetric
        # backend decode), and the backend's solves and evictions.
        self.events: collections.Counter = collections.Counter()
        self._frame_events: dict = {}
        self._t_last_frame: Optional[float] = None
        self._callback = None
        self._last_T_WC = None
        self._n_done = 0
        self._n_frames_total = 0
        self._t_start = time.perf_counter()

    # ------------------------------------------------------------------ run

    def _upload(self, entries: list) -> torch.Tensor:
        """One window's uint8 frames -> [K, H, W, 3] on the device, staged in
        pinned memory and copied without blocking the host."""
        imgs = torch.from_numpy(np.stack([e[2] for e in entries]))
        if self.device.type == "cuda":
            return imgs.pin_memory().to(self.device, non_blocking=True)
        return imgs

    def run(self, dataset: Dataset | str | Path,
            callback: Optional[Callable[[Frame, Keyframes], None]] = None,
            max_frames: Optional[int] = None) -> dict:
        if isinstance(dataset, (str, Path)):
            dataset = load_dataset(dataset)
        n_frames = len(dataset) if max_frames is None else min(len(dataset), max_frames)
        loader = PrefetchLoader(dataset, img_size=self.resolution, patch=self.model.patch_size)
        self.timestamps, self.poses = [], []
        self._callback = callback
        self._n_frames_total = n_frames
        self._n_done = 0
        self._t_start = time.perf_counter()
        self._last_T_WC = None

        # [(window handle, its frames' timestamps)] dispatched, awaiting the
        # drain: one full window in flight, or the tail's windows of one
        pending: list[tuple] = []
        sync_every = max(1, self.config.runtime.sync_every)

        def drain() -> None:
            """The one drain: the pending windows' stats in one read, then
            their frames resolved in order."""
            if not pending:
                return
            held, pending[:] = list(pending), []
            stats = self.tracker.sync_chain([h for h, _ts in held])
            self._count_promotions(stats)
            self._drain_window([e for h, ts in held
                                for e in zip(h["frames"], ts, h["out"]["rows"])],
                               stats, corr=held[-1][0]["corr"])

        def process_batch(entries, batch_dev) -> None:
            if entries[0][0] == 0:
                h, w = entries[0][2].shape[:2]
                self._initialize_state(h, w)
            use_pipeline = self.config.runtime.pipeline and self.tracker.can_pipeline
            if (use_pipeline and self.state.mode == Mode.TRACKING
                    and len(entries) == sync_every and self.keyframes.last_index() is not None):
                frames = [create_frame(i, batch_dev[j]) for j, (i, _t, _u) in enumerate(entries)]
                handle = self.tracker.dispatch_window(frames, batch_dev, T_init=self._last_T_WC)
                if handle is not None:
                    self.events["chained_step"] += len(frames)
                    drain()  # the window before this one
                    if self.tracker._chain is None:
                        # the drain went into RELOC and aborted the chain: this
                        # window ran against the old state; count what it ran
                        # (one more host read, on this rare path), replay it
                        self._count_promotions(self.tracker.sync_chain([handle]))
                        for j, (_i, ts, _u) in enumerate(entries):
                            self._step_sync(frames[j], ts)
                    else:
                        pending.append((handle, [ts for _i, ts, _u in entries]))
                    return
            drain()
            for j, (i, timestamp, _u8) in enumerate(entries):
                frame = create_frame(i, batch_dev[j])
                if use_pipeline and self.state.mode == Mode.TRACKING:
                    handle = self.tracker.dispatch(frame, T_init=self._last_T_WC)
                    if handle is not None:
                        self.events["chained_step"] += 1
                        pending.append((handle, [timestamp]))
                        continue
                drain()
                self._step_sync(frame, timestamp)
            drain()

        raw: list[tuple] = []  # [(frame index, timestamp, uint8 image)]
        upload_q: list[tuple] = []  # [(entries, device batch)], one ahead

        def enqueue_batch() -> None:
            if not raw:
                return
            entries, raw[:] = list(raw), []
            with span("slam.upload", frames=tuple(e[0] for e in entries)):
                upload_q.append((entries, self._upload(entries)))
            while len(upload_q) > 1:
                process_batch(*upload_q.pop(0))

        with torch.no_grad(), TRACER.running(self.device, self.config.runtime.trace):
            for i, (timestamp, processed) in enumerate(loader(max_frames=n_frames)):
                TRACER.mark((i,), "taken")
                raw.append((i, timestamp, processed["unnormalized_img"]))
                if len(raw) >= sync_every:
                    enqueue_batch()
            enqueue_batch()
            while upload_q:
                process_batch(*upload_q.pop(0))
            drain()
            self._run_backend(budget=0)  # drain any deferred backend tasks
            if self.viewer is not None:
                self._publish_viewer()  # with the backend's last corrections
        if self.config.runtime.trace and self.config.runtime.trace_path:
            TRACER.write_chrome(self.config.runtime.trace_path)
            print(f"Trace: {self.config.runtime.trace_path}")
        print(f"Done! {len(self.keyframes)} keyframes, {len(self.poses)} poses")
        if self.metrics:
            self.metrics.close()
            print("Run metrics:", summarize(self.config.runtime.metrics_path))
        return self._get_results()

    def _count_promotions(self, stats: np.ndarray) -> None:
        """The promotions a drained window's steps ran on the device, from its
        events (those after a skip included: the chain ran them)."""
        self.events["chained_promotion"] += int((stats[..., 3] == EVENT_NEW_KF).sum())

    def _step_sync(self, frame: Frame, timestamp: float) -> None:
        """Synchronous per-frame step (INIT, RELOC, no pipeline)."""
        TRACER.mark((frame.frame_id,), "dispatched")
        if self.state.mode == Mode.INIT:
            self._process_init(frame)
        elif self.state.mode == Mode.TRACKING:
            self._process_tracking(frame)
        elif self.state.mode == Mode.RELOC:
            self._process_reloc(frame)
        TRACER.mark((frame.frame_id,), "drained")
        self._bookkeep(frame, timestamp)

    @traced("slam.drain_window")
    def _drain_window(self, entries: list[tuple], stats: np.ndarray, corr) -> None:
        """Resolve a window of chained results, frame by frame, from the
        event codes (0 tracked / 1 promoted / 2 skipped). `entries` is
        [(frame, timestamp, row)], `row` one frame's step outputs; `stats`
        [K, 6] came from one read. On a skip the chain is aborted, the frame
        goes through relocalisation and the window's later frames replay
        synchronously."""
        cur = self.keyframes.last_index()
        pose_dirty = False
        deferred: list[tuple] = []
        completed = True
        for j, (frame, timestamp, row) in enumerate(entries):
            event = int(round(float(stats[j, 3])))
            if event == EVENT_SKIP:
                # the chain's keyframe state as of the failure, then rewind
                self.keyframes.write_pointmap(cur, row["ret_X"], row["ret_C"], float(stats[j, 5]))
                self.tracker.commit_chain_frame(frame, row, stats[j], tracked=False)
                self.tracker.abort_chain()
                print(f"Skipped frame {frame.frame_id}")
                self._frame_events["skipped"] = True
                self.state.mode = Mode.RELOC
                self._process_reloc(frame)
                self._bookkeep(frame, timestamp)
                deferred = entries[j + 1:]
                completed = False
                break
            self.tracker.commit_chain_frame(frame, row, stats[j])
            if event == EVENT_NEW_KF:
                # retire the old keyframe's fused state into its slot; the new
                # keyframe's mono pointmap came from the step's promotion
                self.keyframes.write_pointmap(cur, row["ret_X"], row["ret_C"], float(stats[j, 5]))
                frame.X_canon, frame.C = row["kf_X"], row["kf_C"]
                victim = self._evict_if_full()
                if victim is not None and victim < cur:
                    cur -= 1
                kf_idx = self.keyframes.append(frame)
                self.retrieval_db.update(frame, add_after_query=True)
                self.state.queue_global_optimization(kf_idx)
                self._frame_events["new_kf"] = True
                cur = kf_idx
            if self._bookkeep(frame, timestamp):
                pose_dirty = True
        if completed:
            # flush the chain's latest keyframe state into the arena and
            # queue the backend's pose corrections for the next dispatch
            last_row = entries[-1][2]
            self.keyframes.write_pointmap(cur, last_row["kf_X"], last_row["kf_C"],
                                          float(stats[-1, 4]))
            if pose_dirty:
                self.tracker.queue_arena_correction(self.keyframes.T_WC[cur], last_row["kf_T"],
                                                    corr)
            self.tracker.refresh_chain(cur)
        for frame, timestamp, _row in deferred:
            self._step_sync(frame, timestamp)

    def _promote_keyframe(self, frame: Frame) -> None:
        """New keyframe on the synchronous path: one mono decode from the
        frame's cached encoder tokens."""
        X, C, feat, pos = mast3r_inference_mono(self.model, frame)
        frame.X_canon, frame.C, frame.feat, frame.pos = X, C, feat, pos
        frame.N = frame.N_updates = 1
        self.tracker.abort_chain()
        self._evict_if_full()
        kf_idx = self.keyframes.append(frame)
        self.retrieval_db.update(frame, add_after_query=True)
        self.state.queue_global_optimization(kf_idx)
        self._frame_events["new_kf"] = True

    def _evict_if_full(self) -> Optional[int]:
        """When the arena is full, evict the lowest-covisibility keyframe
        outside the gauge anchors and the `runtime.eviction_protect` most
        recent ones, keeping the graph, the retrieval database and the
        backend queue consistent. Returns the evicted index or None."""
        n = len(self.keyframes)
        if n < self.keyframes.capacity or self.config.runtime.eviction == "off":
            return None
        pin = self.config.local_opt.pin
        protect = max(1, self.config.runtime.eviction_protect)
        lo, hi = pin, n - protect
        if lo >= hi:  # tiny arenas: keep the anchor and the current keyframe
            lo, hi = min(pin, n - 1), n - 1
        if lo >= hi:
            return None
        deg = self.factor_graph.edge_degree(n)
        victim = min(range(lo, hi), key=lambda i: (deg[i], i))
        self.factor_graph.remove_keyframe(victim)
        self.keyframes.remove(victim)
        self.retrieval_db.remove(victim)
        self.state.global_optimizer_tasks = [
            t - 1 if t > victim else t for t in self.state.global_optimizer_tasks if t != victim
        ]
        # the slots shifted under the tracker's cache; a live chain holds
        # copies and its slot index is remapped by the caller
        self.tracker._kf_cache = None
        self.events["eviction"] += 1
        print(f"Evicted keyframe {victim} (degree {int(deg[victim])})")
        if self.metrics:
            self.metrics.log(dict(event="eviction", victim=victim, degree=int(deg[victim])))
        return victim

    @traced("slam.bookkeep")
    def _bookkeep(self, frame: Frame, timestamp: float) -> int:
        """Per-frame records and the backend drain; returns solves run."""
        self.timestamps.append(timestamp)
        self.poses.append(frame.T_WC)
        self._last_T_WC = frame.T_WC
        if self._callback:
            self._callback(frame, self.keyframes)
        TRACER.mark((frame.frame_id,), "committed")
        solves = self._run_backend()
        if self.metrics:
            self._log_frame(frame, timestamp, solves)
        if self.viewer is not None and (
                self._frame_events.get("new_kf", False)
                or self._n_done % max(1, self.config.runtime.viewer_refresh) == 0):
            self._publish_viewer()
        self._frame_events = {}
        self._n_done += 1
        if self._n_done % 10 == 0:
            dt = time.perf_counter() - self._t_start
            print(f"Processed {self._n_done}/{self._n_frames_total} frames, "
                  f"{len(self.keyframes)} keyframes, {self._n_done / dt:.2f} FPS")
        snap_every = self.config.runtime.snapshot_every
        if snap_every and self._n_done % snap_every == 0:
            self.save_state(self.config.runtime.snapshot_path)
        return solves

    def _log_frame(self, frame: Frame, timestamp: float, solves: int) -> None:
        """The frame's metrics record: host values only (the match statistics
        are those the loop has read already)."""
        now = time.perf_counter()
        prev = self._t_start if self._t_last_frame is None else self._t_last_frame
        rec = dict(event="frame", frame=frame.frame_id, ts=timestamp, frame_ms=(now - prev) * 1e3,
                   mode=self.state.mode.name, n_keyframes=len(self.keyframes),
                   n_edges=self.factor_graph.n_edges, backend_solves=solves)
        if self.tracker.last_stats:
            rec.update(self.tracker.last_stats)
        rec.update(self._frame_events)
        self.metrics.log(rec)
        self._t_last_frame = now

    def _initialize_state(self, h: int, w: int) -> None:
        if hasattr(self.model, "set_out_hw"):
            self.model.set_out_hw(h, w)
        f = max(1, self.config.dataset.img_downsample)
        self.keyframes = Keyframes(h // f, w // f, device=self.device)
        self.state = SLAMState(mode=Mode.INIT)
        if self.config.use_calib and self.config.dataset.calib:
            fx, fy, cx, cy = self.config.dataset.calib
            if f > 1:
                # the arena holds the subsampled grid: u' = (u + 0.5) / f - 0.5
                fx, fy = fx / f, fy / f
                cx, cy = (cx + 0.5) / f - 0.5, (cy + 0.5) / f - 0.5
            self.keyframes.set_intrinsics(torch.tensor(
                [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=torch.float32,
                device=self.device))
        self.tracker = FrameTracker(self.model, device=self.device, keyframes=self.keyframes)
        K = self.keyframes.get_intrinsics() if self.config.use_calib else None
        self.factor_graph = FactorGraph(self.model, self.keyframes, K)
        self.retrieval_db = load_retriever(self.model)
        self.retrieval_db.keyframes = self.keyframes
        if self.config.runtime.metrics_path:
            self.metrics = MetricsLogger(self.config.runtime.metrics_path)
        if self.config.runtime.viewer_port and self.viewer is None:
            self.viewer = LiveViewer(self.config.runtime.viewer_port)
            print(f"Live viewer: http://localhost:{self.viewer.port}/")

    # ------------------------------------------------------- checkpointing

    def save_state(self, path) -> None:
        """Snapshot the SLAM state (arena, graph, retrieval, poses; not the
        model weights) to `path` (`utils.snapshot`)."""
        save_snapshot(self, path)
        print(f"Saved SLAM state to {path}")

    def load_state(self, path) -> None:
        """Resume from a snapshot of a run with the same model and dataset
        geometry (`utils.snapshot`)."""
        load_snapshot(self, path)
        print(f"Resumed SLAM state from {path}")

    # ----------------------------------------------------------- mode steps

    def _process_init(self, frame: Frame) -> None:
        self.events["init"] += 1
        X, C, feat, pos = mast3r_inference_mono(self.model, frame)
        frame.X_canon, frame.C, frame.feat, frame.pos = X, C, feat, pos
        frame.N = frame.N_updates = 1
        if self.config.use_calib and self.keyframes.K is None:
            # calibration-free: the focal from the first mono pointmap
            K = estimate_intrinsics(X, (self.keyframes.h, self.keyframes.w), C)
            self.keyframes.set_intrinsics(K)
            self.factor_graph.K = K
            print(f"Estimated focal: {float(K[0, 0]):.1f}px")  # the run's one read of K
        self.keyframes.append(frame)
        self.retrieval_db.update(frame, add_after_query=True)
        self.state.queue_global_optimization(0)
        self.state.mode = Mode.TRACKING
        print("Initialized with first keyframe")

    def _process_tracking(self, frame: Frame) -> None:
        self.events["sync_step"] += 1
        new_kf, _info, try_reloc = self.tracker.track(frame, mast3r_match_asymmetric)
        if try_reloc:
            self._frame_events["skipped"] = True
            self.state.mode = Mode.RELOC
            self._process_reloc(frame)
            return
        if new_kf:
            self.events["sync_promotion"] += 1
            self._promote_keyframe(frame)

    def _process_reloc(self, frame: Frame) -> None:
        """Retrieval, a tentative keyframe, and rollback on failure."""
        self._frame_events["reloc"] = True
        self.events["reloc"] += 1
        self.events["reloc_encode"] += frame.feat is None
        self.tracker.abort_chain()
        X, C, feat, pos = mast3r_inference_mono(self.model, frame)
        frame.X_canon, frame.C, frame.feat, frame.pos = X, C, feat, pos
        frame.N = frame.N_updates = 1
        rcfg = self.config.retrieval
        similar = self.retrieval_db.update(frame, add_after_query=False, k=rcfg.k,
                                           min_thresh=rcfg.min_thresh)
        victim = self._evict_if_full()
        if victim is not None:
            similar = [s - 1 if s > victim else s for s in similar if s != victim]
        if similar:
            kf_idx = self.keyframes.append(frame)
            success = False
            for ref_idx in similar:
                # edge order (new keyframe, candidate): the consecutive-edge
                # exemption of add_factors never applies to candidates
                if self.factor_graph.add_factors([kf_idx], [ref_idx],
                                                 min_match_frac=self.config.reloc.min_match_frac,
                                                 is_reloc=self.config.reloc.strict):
                    success = True
                    print(f"Relocalized! frame {frame.frame_id} -> KF {ref_idx}")
                    frame.T_WC = self.keyframes.T_WC[ref_idx].clone()
                    self.keyframes.write_pose(kf_idx, frame.T_WC)
                    self.retrieval_db.update(frame, add_after_query=True)
                    self._solve_graph()
                    self.events["reloc_solve"] += 1
                    break
            if not success:
                self.keyframes.pop_last()
                print(f"Relocalization failed for frame {frame.frame_id}")
        else:
            kf_idx = self.keyframes.append(frame)
            self.retrieval_db.update(frame, add_after_query=True)
            self.state.queue_global_optimization(kf_idx)
            print(f"No similar keyframes, added frame {frame.frame_id} as new KF")
        self.state.mode = Mode.TRACKING
        self.tracker.reset_idx_f2k()

    def _run_backend(self, budget: Optional[int] = None) -> int:
        """Drain queued backend tasks, at most `budget` of them (default
        `local_opt.backend_tasks_per_frame`; 0 or None drains all)."""
        if budget is None:
            budget = self.config.local_opt.backend_tasks_per_frame or 0
        solves = 0
        while budget <= 0 or solves < budget:
            idx = self.state.dequeue_global_optimization()
            if idx is None:
                break
            with span("slam.backend", keyframe=idx):
                ii = list(range(max(0, idx - 3), idx))
                if ii:
                    self.factor_graph.add_factors(
                        ii, [idx] * len(ii), min_match_frac=self.config.local_opt.min_match_frac)
                self._solve_graph()
            solves += 1
        self.events["backend_solve"] += solves
        return solves

    def _solve_graph(self) -> None:
        """The backend solve of the configured mode: calibrated with
        `use_calib`, else rays."""
        if self.config.use_calib:
            self.factor_graph.solve_GN_calib()
        else:
            self.factor_graph.solve_GN_rays()

    # --------------------------------------------------------------- output

    def _publish_viewer(self, stride: int = 16) -> None:
        """Push the trajectory and every keyframe's cloud (each pointmap
        moved by its current pose, so backend corrections show) to the live
        viewer, and drop the clouds of evicted keyframes. Called on a
        promotion and every `runtime.viewer_refresh` frames only: reading
        the poses and pointmaps waits for the device."""
        v = self.viewer
        traj = (torch.stack(self.poses).cpu().numpy() if self.poses
                else np.zeros((0, 8), np.float32))
        v.publish_traj(traj, mode=self.state.mode.name)
        cnt = len(self.keyframes)
        if cnt == 0:
            return
        XW = lie.sim3_act(self.keyframes.T_WC[:cnt, None],
                          self.keyframes.X[:cnt, ::stride]).cpu().numpy()
        live = set()
        for k in range(cnt):
            fid = int(self.keyframes.frame_ids[k])
            live.add(fid)
            cols = self._viewer_colors.get(fid)
            if cols is None:
                img = self.keyframes.imgs[k].clamp(0, 1).reshape(-1, 3)[::stride]
                cols = (img.cpu().numpy() * 255).astype(np.uint8)
                self._viewer_colors[fid] = cols
            # a pointmap subsampled by img_downsample has other pixels: grey
            v.publish_keyframe(fid, XW[k], cols if len(cols) == len(XW[k]) else None, stride=1)
        for fid in [f for f in list(v._clouds) if f not in live]:
            v.remove_keyframe(fid)
        self._viewer_colors = {f: c for f, c in self._viewer_colors.items() if f in live}

    def _get_results(self) -> dict:
        pose_mats = (lie.sim3_matrix(torch.stack(self.poses)).cpu().numpy() if self.poses
                     else np.zeros((0, 4, 4)))
        points, colors = [], []
        for k in range(len(self.keyframes)):
            kf = self.keyframes[k]
            points.append(lie.sim3_act(kf.T_WC[None], kf.X_canon).cpu().numpy())
            img = kf.img.cpu().numpy()
            colors.append((np.clip(img, 0, 1).reshape(-1, 3) * 255).astype(np.uint8))
        return {
            "timestamps": np.asarray(self.timestamps),
            "poses": pose_mats,
            "points": np.concatenate(points) if points else np.zeros((0, 3)),
            "colors": np.concatenate(colors) if colors else np.zeros((0, 3), np.uint8),
            "keyframe_indices": list(self.keyframes.frame_ids),
        }

    def save_trajectory(self, path: str | Path, format: str = "tum") -> None:
        poses = torch.stack(self.poses).cpu().numpy()
        if format == "tum":
            save_trajectory_tum(path, self.timestamps, poses)
        elif format == "kitti":
            save_trajectory_kitti(path, poses)
        else:
            raise ValueError(f"unknown trajectory format {format!r}")
        print(f"Saved trajectory to {path}")

    def save_pointcloud(self, path: str | Path) -> None:
        results = self._get_results()
        if len(results["points"]) == 0:
            print("No points to save")
            return
        save_ply(path, results["points"], results["colors"])
        print(f"Saved {len(results['points'])} points to {path}")


def main(argv: list[str] | None = None) -> int:
    """Command line: run the SLAM loop over a dataset on the card."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m mast3r_slam_torch.slam",
                                 description=SLAM.__doc__)
    ap.add_argument("dataset", help="dataset path (TUM/EuRoC dir, image folder, video)")
    ap.add_argument("--config", default=None)
    ap.add_argument("--model-type", default="mast3r_full", choices=["mast3r_full", "dunemast3r"])
    ap.add_argument("--variant", default="base", choices=["small", "base"],
                    help="dunemast3r's encoder width")
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="local upstream-named weights (safetensors, .npz or .pth), loaded "
                         "strictly")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--save-traj", default=None, metavar="PATH")
    ap.add_argument("--traj-format", default="tum", choices=["tum", "kitti"])
    ap.add_argument("--save-ply", default=None, metavar="PATH")
    ap.add_argument("--viewer-port", type=int, default=None, metavar="PORT",
                    help="serve the live map/trajectory viewer on this port")
    args = ap.parse_args(argv)
    if args.config:
        load_config(args.config)
    if args.checkpoint:
        cfg = get_config()
        cfg.model.checkpoint = args.checkpoint
        set_config(cfg)
    slam = SLAM(model_type=args.model_type, model_variant=args.variant,
                resolution=args.resolution, precision=args.precision, device=args.device,
                seed=args.seed)
    if args.viewer_port is not None:
        slam.config.runtime.viewer_port = args.viewer_port
    slam.run(args.dataset, max_frames=args.max_frames)
    if args.save_traj:
        slam.save_trajectory(args.save_traj, format=args.traj_format)
    if args.save_ply:
        slam.save_pointcloud(args.save_ply)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
