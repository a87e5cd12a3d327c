"""Where the time of the port's tracking step goes, on one NVIDIA GPU.

    python3 -m mast3r_slam_torch.profile_step [--frames 8] [--out build/profile]

Runs mast3r_full (ViT-L/16, 512x384, bf16, random seeded weights) under
bench.py's tracking settings (`workload`), as chip_smoke.py's main path
does: one warm-up window, one timed window (host clock around work that
ends in a synchronize), one window under torch.profiler, then one window
under ``torch.cuda.set_sync_debug_mode("warn")``. Prints one JSON line:
ms/frame (unprofiled), the device busy time per frame (the union of kernel,
memcpy and memset intervals in the trace) and the idle share it leaves of the
unprofiled frame, kernels per frame, device busy time, kernels and host time
per tracking stage (the tracker's record_function spans), the top kernels by
device time, and the host synchronisations per frame by source line. The
chrome trace (tens of MB) is written under --out.
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
    """Device busy time, launches, per-stage device time, launches and host
    time, and the top kernels of a chrome trace written by torch.profiler."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in kernels]
    stages_dev: dict[str, float] = {}
    stages_kernels: dict[str, int] = {}
    for ann in (e for e in events if e.get("cat") == "gpu_user_annotation"
                and e.get("name", "").startswith("track.")):
        lo, hi = ann["ts"], ann["ts"] + ann["dur"]
        inside = [(s, t) for s, t in spans if lo <= s < hi]
        stages_dev[ann["name"]] = stages_dev.get(ann["name"], 0.0) + _union_ms(inside)
        stages_kernels[ann["name"]] = stages_kernels.get(ann["name"], 0) + len(inside)
    stages_host: dict[str, float] = {}
    for ann in (e for e in events if e.get("cat") == "user_annotation"
                and e.get("name", "").startswith("track.")):
        stages_host[ann["name"]] = stages_host.get(ann["name"], 0.0) + ann["dur"] / 1e3
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
        stage_device_busy_ms_per_frame={k: v / frames for k, v in sorted(stages_dev.items())},
        stage_kernels_per_frame={k: v / frames for k, v in sorted(stages_kernels.items())},
        stage_host_ms_per_frame={k: v / frames for k, v in sorted(stages_host.items())},
        top_kernels=[dict(name=n[:100], device_ms_per_frame=t / frames, calls_per_frame=c / frames)
                     for n, (t, c) in top],
    )


def count_syncs(fn) -> dict[str, int]:
    """Synchronizing CUDA calls made while fn() runs, by the innermost source
    line of this repository on the Python stack at the call."""
    import torch

    counts: dict[str, int] = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(REPO)]
        site = (f"{os.path.relpath(ours[-1].filename, REPO)}:{ours[-1].lineno}" if ours
                else f"{filename}:{lineno}")
        counts[site] = counts.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
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
    from mast3r_slam_torch.models import MASt3RModel
    from mast3r_slam_torch.ops import build
    from mast3r_slam_torch.tracker import FrameTracker
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
    imgs = torch.from_numpy(drift_frames(base, 4 * k, rng)).cuda()

    tracker = FrameTracker(model, cfg)
    tracker.init_keyframe(base)
    tracker.track_window(imgs[:k])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracker.track_window(imgs[k: 2 * k])
    torch.cuda.synchronize()
    ms_frame = (time.perf_counter() - t0) * 1e3 / k

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tracker.track_window(imgs[2 * k: 3 * k])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = os.path.join(args.out, "trace.json")
    prof.export_chrome_trace(trace)
    result = dict(card=card, frames=k, ms_per_frame=ms_frame, profiled_ms_per_frame=wall_ms / k,
                  **summarize_trace(trace, k))
    result["device_idle_share"] = 1.0 - result["device_busy_ms_per_frame"] / ms_frame
    syncs = count_syncs(lambda: tracker.track_window(imgs[3 * k:]))
    result["host_syncs_per_frame"] = sum(syncs.values()) / k
    result["host_sync_sites_per_frame"] = {site: c / k for site, c in sorted(syncs.items())}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
