"""Per-run metrics: one JSON object per frame (the port of
``mast3r_slam_tpu/utils/metrics.py``, the same records and summary).

`MetricsLogger` appends JSON lines to a file behind `runtime.metrics_path`
(empty: off). `SLAM` logs a "frame" record per frame (its time, mode,
keyframes, edges, backend solves, the tracker's match statistics and the
frame's events) and an "eviction" record per eviction. The match statistics
come from the values the loop has already read (a window's one stats read),
so the records add no device read. `summarize` reduces a run's file to its
headline numbers; ``python -m mast3r_slam_torch.utils.metrics run.jsonl``
prints them.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import IO, Optional


class MetricsLogger:
    """Append-only JSON-lines sink; the file is created at the first record."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fh: Optional[IO[str]] = None

    def _handle(self) -> IO[str]:
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("w")
        return self._fh

    def log(self, record: dict) -> None:
        fh = self._handle()
        fh.write(json.dumps(record, separators=(",", ":")) + "\n")
        fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_metrics(path: str | Path) -> list[dict]:
    with Path(path).open() as fh:
        return [json.loads(line) for line in (raw.strip() for raw in fh) if line]


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    i = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[i]


def summarize(path: str | Path) -> dict:
    """A run's metrics file -> frames, fps, frame time p50/p95, keyframes,
    keyframe / reloc / skip events, evictions, mean match fraction and
    backend solves."""
    records = read_metrics(path)
    frames = [r for r in records if r.get("event") == "frame"]
    if not frames:
        return {"n_frames": 0}
    frame_ms = sorted(r["frame_ms"] for r in frames if "frame_ms" in r)
    match_fracs = [r["match_frac"] for r in frames if r.get("match_frac") is not None]
    total_s = sum(frame_ms) / 1e3
    return {
        "n_frames": len(frames),
        "fps": len(frames) / total_s if total_s > 0 else float("nan"),
        "frame_ms_p50": _percentile(frame_ms, 0.50),
        "frame_ms_p95": _percentile(frame_ms, 0.95),
        "n_keyframes": max((r.get("n_keyframes", 0) for r in frames), default=0),
        "n_kf_events": sum(1 for r in frames if r.get("new_kf")),
        "n_reloc_events": sum(1 for r in frames if r.get("reloc")),
        "n_skipped": sum(1 for r in frames if r.get("skipped")),
        "n_evictions": sum(1 for r in records if r.get("event") == "eviction"),
        "mean_match_frac": sum(match_fracs) / len(match_fracs) if match_fracs else None,
        "backend_solves": sum(r.get("backend_solves", 0) for r in frames),
    }


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m mast3r_slam_torch.utils.metrics",
                                 description="Summarize a run's metrics file")
    ap.add_argument("path", help="metrics .jsonl written by SLAM.run")
    args = ap.parse_args(argv)
    print(json.dumps(summarize(args.path), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
