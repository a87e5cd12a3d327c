"""The readings a cell's limits are set from: the compared numbers of the
program over many seeds, and of the control (the port's own int8-weight path,
``runtime.weight_quant``'s quantizer switched on after the weights are
loaded), each at the cell's own size and load, with a short window.

    python3 -m slam_bench.readings --workload <cell> --seeds 1 2 3 [--control int8]
        [--seconds 6] [--out build/readings.jsonl] [--frames-out build/frames.jsonl]

One process runs every seed (the kernels are built once); each seed builds
its own model, stream and SLAM. Each line also carries the stage controls'
readings (``control.<name>``: the solve and the fusion in bfloat16, on the
same samples). Prints and appends one JSON line per seed; with
``--frames-out``, appends there one line per seed of each sampled frame's
pose readings (`check.slam_steps`). The benchmark's own runs never run a
control.
"""

from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from slam_bench import run as bench_run  # noqa: E402,F401  (sets the cache directories)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m slam_bench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--control", default=None, choices=(None, "int8"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--frames-out", default=None)
    args = ap.parse_args(argv)

    import torch

    from slam_bench import manifest

    if not torch.cuda.is_available():
        print("slam_bench.readings: needs a CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    entry = manifest.entry(cell.traffic["entry"])
    for seed in args.seeds:
        t = time.perf_counter()
        rec, numbers = entry.run(cell, seed, args.seconds, False, t, control=args.control,
                                 controls=True, per_frame=bool(args.frames_out))
        per_frame = numbers.pop("frames", None)
        line = dict(workload=args.workload, seed=seed, control=args.control,
                    frames=len(rec.window_commits()), setup_s=rec.t0 - t,
                    wall_s=time.perf_counter() - t, **numbers)
        print(json.dumps(line), flush=True)
        for path, rec_ in ((args.out, line), (args.frames_out, dict(
                workload=args.workload, seed=seed, control=args.control, frames=per_frame))):
            if path:
                Path(path).parent.mkdir(parents=True, exist_ok=True)
                with open(path, "a") as f:
                    f.write(json.dumps(rec_) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
