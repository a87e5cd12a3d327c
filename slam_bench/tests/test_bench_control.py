"""The check's control on the card, at each cell's own size and load, on
three seeds: the port's int8-weight path in the program's place comes out
not correct. Needs an NVIDIA GPU (about two minutes a cell there):

    python -m pytest -p no:cacheprovider -m cuda slam_bench/tests/test_bench_control.py
"""

import time

import pytest

from slam_bench import check, manifest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in manifest.benchmark()["workloads"]])
def test_control_is_not_correct(card, name):
    cell = manifest.cell(name)
    entry = manifest.entry(cell.traffic["entry"])
    for seed in (4000000001, 4000000002, 4000000003):
        _, numbers = entry.run(cell, seed, 6.0, False, time.perf_counter(), control="int8")
        ok, checks = check.verdict(numbers, cell.spec["limits"])
        assert not ok, (seed, checks)

