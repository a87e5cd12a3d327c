"""The benchmark's data, found by name: `BENCHMARK.json` at the root of the
checkout, and under this folder one file per configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``), cell
(``cells/<name>.json``), per-layer metric reader (``metrics/<name>.py``) and
entry (``entries/<name>.py``). A new cell, mix or metric is new files
and manifest entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    spec: dict  # cells/<name>.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    end_to_end: list  # the metric entries this cell reports
    per_layer: list


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    spec = _json(HERE / "cells" / f"{name}.json")
    if (spec["config"], spec["traffic"]) != (w["config"], w["traffic"]):
        raise ValueError(f"cells/{name}.json names {spec['config']}/{spec['traffic']}, "
                         f"BENCHMARK.json {w['config']}/{w['traffic']}")
    return Cell(name=name, chips=w["chips"], spec=spec,
                config=_json(HERE / "configs" / f"{w['config']}.json"),
                traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def entry(name: str):
    return load_module(HERE / "entries" / f"{name}.py", f"slam_bench_entry_{name}")


def reader(metric: str):
    return load_module(HERE / "metrics" / f"{metric}.py",
                       "slam_bench_metric_" + metric.replace(".", "_").replace("-", "_"))
