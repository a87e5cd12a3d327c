"""Stage timing and device traces (the port of
``mast3r_slam_tpu/utils/profiling.py``).

* `StageTimer`: wall time accumulated per named stage; ``stage(name,
  sync_value=...)`` waits for the device before it stops the clock, so a
  stage whose work is still queued on the card is timed honestly.
* `trace`: a `torch.profiler` window over the CPU and, where there is one,
  the card, written as a Chrome trace (``trace.json``) under `log_dir`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


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
