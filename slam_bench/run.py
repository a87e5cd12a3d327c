"""Run one cell of the port's benchmark once.

    python3 -m slam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``: from this module's first line to the window's first
frame) loads the cell's files (`manifest`), builds the kernels, the model
and the stream from the seed and warms the cell up; then the window
measures ``--seconds``; then the plain reference checks a sample of what the
window produced. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each compared number
beside its limit; the same numbers are the last lines on standard error.

Without a CUDA device, with fewer than the cell asks for, or if a JAX module
is loaded once the window has closed, it prints no result and exits non-zero.
Every build and kernel cache lives under ``build/`` in the checkout.
"""

from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)  # fixed paths in the checkout

FORBIDDEN = ("jax", "jaxlib", "flax", "mast3r_slam_tpu")
GIB = float(1 << 30)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card() -> tuple[str, str]:
    import torch

    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return torch.cuda.get_device_name(0), limit.splitlines()[0] if limit else "unknown"


def end_to_end(rec) -> dict:
    from slam_bench.record import p90

    done = rec.window_commits()
    lat = [(t_c - t_t) * 1e3 for _, t_t, t_c in done]
    print(f"[bench] window {rec.seconds} s: {len(done)} frames committed, latency samples "
          f"{len(lat)}", file=sys.stderr)
    values = {"frames_per_s": len(done) / rec.seconds,
              "peak_device_gib": rec.peak_bytes / GIB,
              "setup_s": rec.t0 - rec.t_proc}
    if len(lat) >= 2:
        values["frame_latency_p90_ms"] = p90(lat)
    return values


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m slam_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from slam_bench import check, manifest

    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slam_bench: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    entry = manifest.entry(cell.traffic["entry"])
    rec, numbers = entry.run(cell, args.seed, args.seconds, bool(args.trace), T_PROC)
    bad = forbidden_modules()
    if bad:
        print(f"slam_bench: loaded {bad}: the benchmark runs the port alone", file=sys.stderr)
        return 3
    kind, limit = card()
    correct, checks = check.verdict(numbers, cell.spec["limits"])
    metrics: dict = {}
    if args.trace:
        for m in cell.per_layer:
            v = manifest.reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = end_to_end(rec)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(rec.peak_bytes)}
    # a frame the tracker lost (a skip, then relocalisation) counts as failed
    result = {"correct": bool(correct), "attempted": len(rec.window_commits()),
              "failed": int(rec.events.get("reloc", 0)),
              "metrics": metrics, "device": device}
    if args.trace and rec.summary:
        device["busy_s"], device["window_s"] = rec.summary["busy_s"], rec.summary["window_s"]
        result["breakdown"] = {"device_ops": rec.summary["device_ops"],
                               "idle_gaps": rec.summary["idle_gaps"]}
    result["checks"] = checks
    print(f"[bench] {kind}, power limit {limit}; numbers {json.dumps(numbers)}", file=sys.stderr)
    if rec.sync_sites:
        print(f"[bench] host syncs in the window by site {rec.sync_sites}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
