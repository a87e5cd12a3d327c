"""Where the time of the port's tracking window goes, on one NVIDIA GPU.

    python3 -m mast3r_slam_torch.profile_step [--frames 8] [--out build/profile]

Runs mast3r_full (ViT-L/16, 512x384, bf16, random seeded weights) under
bench.py's tracking settings (`workload`), as chip_smoke.py's main path
does. A window of --frames is one replay of a captured CUDA graph: one
window captures it, then one is timed (host clock from the dispatch through
the drain, the window's one host read). With the port's tracer on
(`utils.profiling`: ``runtime.trace``) the traced graph is then captured
and one window timed: the stages' device ms a frame come from the stamps
captured into the graph (before any profiler session, after which each
skipped IF node costs more). Then one window is replayed under
torch.profiler, one under ``torch.cuda.set_sync_debug_mode("warn")``, and
one traced window under torch.profiler, whose kernels between its stamp
kernels give each stage's kernels. Last, one window runs eagerly
(``capture_windows`` False: the promotion's select form), for its ms/frame.
Prints one JSON line: ms/frame of the captured window, its device busy time
per frame (the union of kernel, memcpy and memset intervals in the trace)
and the idle share it leaves, kernels per frame, the top kernels by device
time, graph launches per window, the host synchronisations per frame by
source line, the traced window's ms/frame, the stage table
(``stage_device_busy_ms_per_frame``, ``stage_kernels_per_frame``), the
clock's calibration, and under "eager" the eager window's ms/frame. The
chrome traces (tens of MB) are written under --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _union_ms(intervals) -> float:
    """Total length of the union of (start_us, end_us) intervals, in ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def summarize_trace(path: str, frames: int) -> dict:
    """Device busy time, launches and the top kernels of a chrome trace
    written by torch.profiler."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in kernels]
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e["name"], [0.0, 0])
        acc[0] += e["dur"] / 1e3
        acc[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    first, last = min(s for s, _ in spans), max(t for _, t in spans)
    return dict(
        device_busy_ms_per_frame=_union_ms(spans) / frames,
        device_span_ms_per_frame=(last - first) / 1e3 / frames,
        kernels_per_frame=len(kernels) / frames,
        top_kernels=[dict(name=n[:100], device_ms_per_frame=t / frames, calls_per_frame=c / frames)
                     for n, (t, c) in top],
    )


def stage_table(rows: list, frames: int) -> dict[str, float]:
    """Device ms a frame per stage from the tracer's rows
    (`profiling.Tracer.device_rows`, `profiling.stage_ns`), over `frames`."""
    from mast3r_slam_torch.utils.profiling import stage_ns

    total: dict[str, float] = {}
    for row in rows:
        for name, ns in stage_ns(row["stamps"]).items():
            total[name] = total.get(name, 0.0) + ns / 1e6
    return {k: v / frames for k, v in sorted(total.items())}


def stage_kernels(path: str, labels: list, frames: int) -> dict[str, float]:
    """Kernels a frame per stage in a profiled replay of a traced graph: the
    trace's kernels between its stamp kernels, each run of them counted to
    the stage whose begin label (`labels`, the graph's stamps) opens it."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e["ts"], e["name"]) for e in events
                     if e.get("ph") == "X" and e.get("cat") == "kernel")
    counts: dict[str, int] = {}
    i, current = -1, None
    for _ts, name in kernels:
        if "stamp_kernel" in name:
            i += 1
            if i < len(labels):
                lab, _slot, edge = labels[i]
                current = lab if edge == 0 and lab.startswith("track.") else None
            continue
        if current is not None and 0 <= i < len(labels):
            counts[current] = counts.get(current, 0) + 1
    return {k: v / frames for k, v in sorted(counts.items())}


def count_syncs(fn) -> dict[str, int]:
    """Synchronizing CUDA calls made while fn() runs, by the innermost source
    line of this repository on the Python stack at the call."""
    import torch

    counts: dict[str, int] = {}
    armed = []  # switching the debug mode on warns once itself: not fn()'s

    def record(message, category, filename, lineno, file=None, line=None):
        if not armed or "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(REPO)]
        site = (f"{os.path.relpath(ours[-1].filename, REPO)}:{ours[-1].lineno}" if ours
                else f"{filename}:{lineno}")
        counts[site] = counts.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        armed.append(True)
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return counts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile"))
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mast3r_slam_torch.config import Config, set_config
    from mast3r_slam_torch.frame import create_frame
    from mast3r_slam_torch.models import MASt3RModel
    from mast3r_slam_torch.ops import build
    from mast3r_slam_torch.tracker import FrameTracker
    from mast3r_slam_torch.utils.profiling import TRACER
    from mast3r_slam_torch.workload import BENCH_SETTINGS, drift_frames

    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    build.build_all()

    cfg = set_config(Config.from_dict(BENCH_SETTINGS))
    model = MASt3RModel.create("mast3r_full", resolution=512, precision="bf16", seed=0)
    h, w = model.out_hw
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    k = args.frames
    imgs = torch.from_numpy(drift_frames(base, 8 * k, rng)).cuda()

    tracker = FrameTracker(model, cfg)
    tracker.init_keyframe(base)
    wins = imgs.split(k)
    # each window's frames, made before any timing or trace
    frames = [[create_frame(j * k + i, img) for i, img in enumerate(x)]
              for j, x in enumerate(wins)]

    def run(j) -> None:
        """Window j dispatched (`dispatch_window`) and drained (`sync_chain`)."""
        tracker.sync_chain([tracker.dispatch_window(frames[j], wins[j])])

    def window(j) -> float:
        """ms/frame of window j, dispatch through drain."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(j)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / k

    def profiled(j, name: str) -> tuple[dict, float]:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ms = window(j)
        trace = os.path.join(args.out, name)
        prof.export_chrome_trace(trace)
        return summarize_trace(trace, k), ms

    traced_cfg = Config.from_dict({**BENCH_SETTINGS, "runtime": {**BENCH_SETTINGS["runtime"],
                                                                 "trace": True}})

    def tracing(on: bool) -> None:
        """The tracer and the config that keys the traced graph, together."""
        set_config(traced_cfg if on else cfg)
        TRACER.start("cuda") if on else TRACER.stop()

    window(0)  # captures the window's graph
    ms_frame = window(1)
    # the traced window before any profiler session (after one, each skipped
    # IF node pays for its body: chip_smoke.py's window_timing)
    tracing(True)
    window(2)  # captures the traced graph
    first = len(TRACER.rows)
    traced_ms = window(3)
    tracing(False)
    timed = [r for r in TRACER.device_rows() if r["index"] >= first]
    result = dict(card=card, frames=k, ms_per_frame=ms_frame, traced_ms_per_frame=traced_ms,
                  stage_device_busy_ms_per_frame=stage_table(timed, k * len(timed)),
                  clock=TRACER.clock())

    captured, profiled_ms = profiled(4, "trace.json")
    with open(os.path.join(args.out, "trace.json")) as f:
        graph_launches = sum(e.get("name") == "cudaGraphLaunch" for e in json.load(f)["traceEvents"])
    result.update(profiled_ms_per_frame=profiled_ms, graph_launches_per_window=graph_launches,
                  **captured)
    result["device_idle_share"] = 1.0 - result["device_busy_ms_per_frame"] / ms_frame
    syncs = count_syncs(lambda: run(5))
    result["host_syncs_per_frame"] = sum(syncs.values()) / k
    result["host_sync_sites_per_frame"] = {site: c / k for site, c in sorted(syncs.items())}

    tracing(True)
    profiled(6, "trace_traced.json")
    tracing(False)
    graph = next(g for g in tracker.graphs.graphs.values() if g.stamps)
    result.update(stage_kernels_per_frame=stage_kernels(
        os.path.join(args.out, "trace_traced.json"), graph.stamps, k),
        stamps_per_window=len(graph.stamps))
    tracker.capture_windows = False  # the eager window, for comparison
    result["eager"] = dict(ms_per_frame=window(7))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
