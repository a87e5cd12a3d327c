"""The captured tracking window on an NVIDIA GPU (marked `cuda`: skipped
without a card), and the guard that tests/test_torch_window_program.py runs
windows under. This file imports no JAX, so it also runs on a card machine
without it, outside the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_window_graph_cuda.py

On phase 5's small bf16 model (chip_smoke.py), two windows of K = 4 frames
through `dispatch_window` and one drain (`sync_chain`), every tracked frame
promoting: the captured window against the eager one (`capture_windows`
False, `branch`'s select form) with events exact and statistics within
phase 5's 0.02, the IF body's device counter equal to the NEW_KF events at
the drain, and a later window of the same length replayed with no host
read.

`dispatch` and `stacked` drive the tracker's window program in the port's tests.
"""

import contextlib
import traceback

import numpy as np
import pytest
import torch

K = 4
HOST_READS = ("__bool__", "item", "tolist", "cpu", "numpy", "__int__", "__float__")


class HostRead(AssertionError):
    pass


@contextlib.contextmanager
def no_host_reads():
    """Every way of reading a tensor's value into Python raises HostRead."""
    saved = {n: torch.Tensor.__dict__.get(n) for n in HOST_READS}

    def refuse(name):
        def read(self, *args, **kwargs):
            port = [f for f in traceback.extract_stack()[:-1] if "mast3r_slam_torch" in f.filename]
            where = f" at {port[-1].filename.split('mast3r_slam_torch')[-1]}:{port[-1].lineno}" \
                if port else ""
            raise HostRead(f"Tensor.{name} inside the window{where}")
        return read

    for n in HOST_READS:
        setattr(torch.Tensor, n, refuse(n))
    try:
        yield
    finally:
        for n, fn in saved.items():
            if fn is None:
                delattr(torch.Tensor, n)
            else:
                setattr(torch.Tensor, n, fn)


def dispatch(tracker, imgs, first: int = 1, **kw):
    """`FrameTracker.dispatch_window` over imgs [K, H, W, 3] (a tensor or an
    array) as the frames first, first + 1, ... -> the window handle."""
    from mast3r_slam_torch.frame import create_frame

    imgs = torch.as_tensor(imgs)
    return tracker.dispatch_window([create_frame(first + j, x) for j, x in enumerate(imgs)],
                                   imgs, **kw)


def stacked(handle) -> dict:
    """A window handle's per-frame rows stacked [K, ...], and its final chain
    state under "final"."""
    rows = handle["out"]["rows"]
    return dict({k: torch.stack([r[k] for r in rows]) for k in rows[0]},
                final=handle["out"]["final"])


@pytest.mark.cuda
def test_captured_window_matches_eager_window_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from mast3r_slam_torch.config import Config, reset_config, set_config
    from mast3r_slam_torch.frame import create_frame
    from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel
    from mast3r_slam_torch.tracker import _PER_FRAME, EVENT_NEW_KF, FrameTracker
    from mast3r_slam_torch.workload import BENCH_SETTINGS, drift_frames

    small = MASt3RConfig(enc_embed_dim=128, enc_depth=2, enc_num_heads=2, dec_embed_dim=128,
                         dec_depth=2, dec_num_heads=2, head_type="dpt", dtype=torch.bfloat16)
    model = MASt3RModel.create(cfg=small, resolution=64, seed=1, device="cuda")
    h, w = model.out_hw
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    imgs = torch.from_numpy(drift_frames(base, 2 * K, rng)).cuda()
    settings = {k: dict(v) for k, v in BENCH_SETTINGS.items()}
    settings["tracking"]["match_frac_thresh"] = 1.0  # every tracked frame promotes
    cfg = set_config(Config.from_dict(settings))
    results = []
    try:
        for eager in (False, True):
            tracker = FrameTracker(model, cfg)
            tracker.capture_windows = not eager
            tracker.init_keyframe(base)
            outs = [dispatch(tracker, imgs[j * K:(j + 1) * K], 1 + j * K) for j in range(2)]
            stats = tracker.sync_chain(outs)
            results.append(stats)
            if not eager:
                runs = int(tracker.graphs.body_runs)
                assert runs == int((stats[:, 3] == EVENT_NEW_KF).sum()) > 0
                frames = [create_frame(1 + 2 * K + j, x) for j, x in enumerate(imgs[:K])]
                with no_host_reads():
                    tracker.dispatch_window(frames, imgs[:K])
    finally:
        reset_config()
    np.testing.assert_array_equal(results[0][:, 3], results[1][:, 3])
    np.testing.assert_allclose(results[0][:, :3], results[1][:, :3], atol=0.02, rtol=0)
    assert set(_PER_FRAME) <= set(stacked(outs[0]))
