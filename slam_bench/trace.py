"""Reduction of a torch.profiler chrome trace of the profiled slice to what
the per-layer readers take: the device's busy intervals, the kernels by
name, the idle gaps named by the benchmark span active on the host, and the
attention kernel's launches and time.

`union_ms` is a frozen copy of ``mast3r_slam_torch/profile_step._union_ms``;
the device intervals are those `profile_step.summarize_trace` takes (kernels,
memcpys and memsets).
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE_SPAN = "bench.slice"


def union_ms(intervals) -> float:
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


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def name_gap(gap: tuple[float, float], spans) -> str:
    """The host span that covers most of `gap`; of spans covering the same
    share, the shortest (the innermost)."""
    best, key = "none", (0.0, 0.0)
    for name, s, e in spans:
        cover = min(e, gap[1]) - max(s, gap[0])
        if cover > 0 and (cover, -(e - s)) > key:
            best, key = name, (cover, -(e - s))
    return best


def summarize(events: list, kernel_symbol: str, top: int = 10) -> dict | None:
    """Busy and wall seconds of the slice (from its first device operation to
    its last), the top device operations, the
    idle time by host span, and the launches and seconds of the kernels whose
    name holds `kernel_symbol`. None when the trace holds no slice span or no
    device work."""
    sl = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE_SPAN
          and e.get("cat") == "user_annotation"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not sl or not dev:
        return None
    lo, hi = sl[0]["ts"], sl[0]["ts"] + sl[0]["dur"]
    dev = [e for e in dev if lo <= e["ts"] < hi]
    if not dev:
        return None
    # from the slice's first device operation to its last: the slice opens
    # on an idle card (it is synchronised first) and closes on a drained one
    lo = min(e["ts"] for e in dev)
    hi = min(hi, max(e["ts"] + e["dur"] for e in dev))
    iv = [(e["ts"], min(e["ts"] + e["dur"], hi)) for e in dev]
    busy = merged(iv)
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("bench.") and e["name"] != SLICE_SPAN]
    idle: dict[str, float] = {}
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            n = name_gap((a, b), spans)
            idle[n] = idle.get(n, 0.0) + (b - a) / 1e6
    att = [e for e in dev if e.get("cat") == "kernel" and kernel_symbol in e["name"]]
    return dict(
        busy_s=union_ms(iv) / 1e3,
        window_s=(hi - lo) / 1e6,
        device_ops=sorted(([n, t] for n, t in by_name.items()), key=lambda x: -x[1])[:top],
        idle_gaps=sorted(([n, t] for n, t in idle.items()), key=lambda x: -x[1])[:top],
        kernel_launches=len(att),
        kernel_s=sum(e["dur"] for e in att) / 1e6,
    )


def load_events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]
