"""The check against a broken timed path: a whole run of the ``slam_run``
entry on the CPU (the harness's look for a card skipped), with the tracking
cells' traffic and limits but a tiny network and two-frame windows, and the
window program broken underneath where it produces its outputs. Sound, the
run is correct; with each fault the cell can have, it is not: the
encoder's output altered, a window handing back the last one's outputs,
half of a window's frames left out, and, where the cell compares the
decoder's pointmap, that output alone altered. (One card: no exchange
between chips to leave out. The pose is not compared: its problems on the
benchmark's random network are singular, see PERF.md.)"""

import copy
import json
import time

import pytest
import torch

from slam_bench import check, manifest
from slam_bench.entries import slam_run

TINY = {"model_type": "tiny", "variant": "base", "resolution": 64, "precision": "fp32",
        "gelu": "erf", "input": {"height": 48, "width": 64},
        "network": {"enc_embed_dim": 64, "enc_depth": 2, "enc_num_heads": 2, "patch_size": 16,
                    "dec_embed_dim": 48, "dec_depth": 2, "dec_num_heads": 2, "head_type": "dpt",
                    "local_feat_dim": 24, "rope_base": 100.0}}
CELLS = ("vitl16-512-track", "dune-b14-336-track")


def tiny_cell(name: str):
    real = manifest.cell(name)
    traffic = json.loads(json.dumps(real.traffic))
    traffic["settings"]["runtime"]["sync_every"] = 2
    traffic["warmup_windows"] = 2
    return manifest.Cell(name="tiny", chips=1, spec=dict(real.spec, sample_frames=4),
                         config=TINY, traffic=traffic, end_to_end=[], per_layer=[])


def altered(out, inputs):
    """A produced answer altered: the encoder's output moved by 0.05 in
    every channel."""
    out["feat"] = out["feat"] + 0.05


def frame_moved(out, inputs):
    """The frame's pointmap alone altered: moved by 5% of its root mean
    square in every channel."""
    x = out["frame_X"]
    out["frame_X"] = x + 0.05 * x.pow(2).mean().sqrt()


class unchanged:
    """The window hands back the outputs it held: each window's rows are the
    previous window's, as if the program had not stepped."""

    __name__ = "unchanged"

    def __init__(self):
        self.held = None

    def __call__(self, out, inputs):
        now = {k: v.clone() for k, v in out.items()}
        if self.held is not None and len(self.held["stats"]) == len(out["stats"]):
            out.update(self.held)
        self.held = now


def half_left_out(out, inputs):
    """Half of the window's frames left out: their outputs are the other
    half's."""
    k = len(out["stats"])
    for key in ("stats", "feat", "frame_X", "frame_C", "T_WCf", "ret_X", "ret_C"):
        out[key] = torch.cat([out[key][: k - k // 2], out[key][: k // 2]])


def run_with(monkeypatch, name, fault):
    from mast3r_slam_torch.tracker import FrameTracker

    if fault is not None:
        orig = FrameTracker._run_window

        def broken(self, imgs, st):
            stacked, final, promotion = orig(self, imgs, st)
            fault(stacked, st)
            return stacked, final, promotion

        monkeypatch.setattr(FrameTracker, "_run_window", broken)
    cell = tiny_cell(name)
    torch.set_num_threads(4)
    _, numbers = slam_run.run(cell, seed=2 ** 31 + 17, seconds=6.0, trace=False,
                              t_proc=time.perf_counter())
    return check.verdict(numbers, cell.spec["limits"])[0], numbers


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(monkeypatch, name):
    ok, numbers = run_with(monkeypatch, name, None)
    assert ok, numbers


FAULTS = [altered, unchanged(), half_left_out]
CASES = [(f, name) for name in CELLS for f in FAULTS] + [(frame_moved, "dune-b14-336-track")]


@pytest.mark.parametrize("fault,name", CASES, ids=lambda x: getattr(x, "__name__", x))
def test_broken_run_is_not(monkeypatch, fault, name):
    ok, numbers = run_with(monkeypatch, name, copy.copy(fault))  # a fresh `unchanged`
    assert not ok, numbers
