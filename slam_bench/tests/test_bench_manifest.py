"""BENCHMARK.json against the contract's shape, and every cell's files found
by name."""

import json
import re

import pytest

from slam_bench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["slam_bench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cell = manifest.cell(w["name"])
    assert cell.chips == 1 and NAME.match(w["name"]) and len(w["why"]) <= 200
    assert manifest.entry(cell.traffic["entry"]).run
    assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
    assert cell.per_layer, "every cell reports a per-layer metric"
    gaps = ("feat_rel", "pts_rel", "conf_rel", "pose_rel", "pose_cost", "pose_cost_gap",
            "fused_rel", "unique_gap")
    biases = ("feat_bias", "pts_bias", "conf_bias", "fused_bias")
    for name in cell.spec["limits"]:
        assert name in ("events",) + biases or name.removesuffix("_med") in gaps


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert c["file"] == f"slam_bench/configs/{c['name']}.json"
    cfg = json.load(open(manifest.ROOT / c["file"]))
    assert set(c["reduced"]) <= set(cfg) and len(c["why"]) <= 200
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metrics(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert callable(manifest.reader(m["name"]).read)
    for w in m.get("workloads", []):
        assert w in {x["name"] for x in BENCH["workloads"]}
