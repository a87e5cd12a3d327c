"""Device policy and import hygiene of the port.

The port's entry points run on the card unless the caller passes
device="cpu"; without CUDA (as here) they raise instead of falling back to
the CPU. The package imports neither jax nor the JAX package.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from mast3r_slam_torch.config import Config
from mast3r_slam_torch.device import resolve_device
from mast3r_slam_torch.frame import create_frame
from mast3r_slam_torch.models import MASt3RModel
from mast3r_slam_torch.tracker import FrameTracker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_without_cuda_raises(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_model_create_without_device_raises(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MASt3RModel.create(model_type="tiny", resolution=64)


def test_frame_tracker_without_device_raises(no_cuda):
    model = MASt3RModel.create(model_type="tiny", resolution=64, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FrameTracker(model, Config())


def test_slam_and_probe_cases_without_device_raise(no_cuda):
    from mast3r_slam_torch import probe_shift
    from mast3r_slam_torch.slam import SLAM

    with pytest.raises(RuntimeError, match="device='cpu'"):
        SLAM()
    for case in probe_shift.CASES.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            case()


def test_parallel_entry_points_without_device_raise(no_cuda, tmp_path):
    import torch.distributed as dist

    from mast3r_slam_torch.parallel import multihost
    from mast3r_slam_torch.parallel.mesh import init_distributed, spawn

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed(0, 1, f"file://{tmp_path / 'a'}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.initialize(f"file://{tmp_path / 'b'}", 1, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spawn(print, 1, workdir=str(tmp_path / "ranks"))
    assert not dist.is_initialized()


def test_frame_tracker_rejects_calib_and_untracked_use(monkeypatch):
    """A calibrated tracker builds on the CPU when asked for it (its
    calibrated step waits for intrinsics in an arena) and, like any tracker,
    raises without CUDA when no device is named; a dispatch before any
    keyframe returns no handle."""
    model = MASt3RModel.create(model_type="tiny", resolution=64, device="cpu")
    calib = Config.from_dict({"use_calib": True})
    tracker = FrameTracker(model, calib, device="cpu")
    assert tracker.use_calib and tracker._step_calib is not None
    assert not tracker._calib_live()  # no arena, no K: the rays step
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FrameTracker(model, calib)
    tracker = FrameTracker(model, Config(), device="cpu")
    assert tracker.dispatch(create_frame(1, torch.zeros(48, 64, 3))) is None


def test_port_imports_no_jax():
    """Run the CPU slice once in a fresh interpreter, then an ASMK fit and
    query and an iterative match, then the Lie classes, the pair selection
    of offline reconstruction and the slice again with int8 weights and the
    speculative window decode, then a training loss and its gradient through
    `parallel` and its trainer; then neither jax nor mast3r_slam_tpu may be in
    sys.modules."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        import mast3r_slam_torch
        from mast3r_slam_torch.config import Config, set_config
        from mast3r_slam_torch.frame import create_frame
        from mast3r_slam_torch.models import MASt3RModel
        from mast3r_slam_torch.models import io, heads, vit  # noqa: F401
        from mast3r_slam_torch.ops import attention, build, dense_match, gauss_newton  # noqa
        from mast3r_slam_torch.tracker import FrameTracker

        cfg = set_config(Config.from_dict({"matching": {"method": "dense", "dense_radius": 2}}))
        model = MASt3RModel.create(model_type="tiny", resolution=64, device="cpu")
        tracker = FrameTracker(model, cfg, device="cpu")
        rng = np.random.default_rng(0)
        tracker.init_keyframe(rng.uniform(0, 1, (48, 64, 3)).astype(np.float32))

        def window():
            imgs = torch.from_numpy(rng.uniform(0, 1, (2, 48, 64, 3)).astype(np.float32))
            handle = tracker.dispatch_window([create_frame(1 + j, x) for j, x in enumerate(imgs)],
                                             imgs)
            return tracker.sync_chain([handle]), [r["T_WCf"] for r in handle["out"]["rows"]]

        stats, poses = window()
        assert stats.shape == (2, 6) and bool(torch.isfinite(torch.stack(poses)).all())

        from mast3r_slam_torch.matching import match_iterative_proj
        from mast3r_slam_torch.models import asmk
        from mast3r_slam_torch.ops import iter_proj, refine  # noqa: F401

        db = asmk.ASMKRetriever(feat_dim=16, n_words=4, proj_dim=4, capacity=4)
        feats = [torch.from_numpy(rng.normal(size=(20, 16)).astype(np.float32)) for _ in range(3)]
        db.fit_codebook(feats)
        for f in feats:
            db.add(f)
        assert db.query(feats[1], k=2)[0][0] == 1
        X, D = torch.rand(1, 8, 8, 3) + 1.0, torch.rand(1, 8, 8, 4)
        idx, valid = match_iterative_proj(X, X, D, D)
        assert idx.shape == (1, 64) and valid.shape == (1, 64, 1)

        from mast3r_slam_torch import offline, retrieval_db, viewer  # noqa: F401
        from mast3r_slam_torch.lie import Sim3
        from mast3r_slam_torch.models import quant  # noqa: F401

        assert float(Sim3.exp(torch.full((1, 7), 0.1)).log().sub(0.1).abs().max()) < 1e-5
        assert retrieval_db.select_pairs_from_retrieval(torch.eye(3)[[0, 1, 0]], k=1) == [
            (0, 1), (0, 2), (1, 2)]
        cfg = set_config(Config.from_dict({
            "matching": {"method": "dense", "dense_radius": 2},
            "runtime": {"window_spec_decode": True, "window_decode_microbatch": 1}}))
        model.quantize_weights("int8")
        tracker = FrameTracker(model, cfg, device="cpu")
        tracker.init_keyframe(rng.uniform(0, 1, (48, 64, 3)).astype(np.float32))
        assert bool(torch.isfinite(torch.stack(window()[1])).all())

        import mast3r_slam_torch.parallel
        from mast3r_slam_torch.parallel import multihost, pipeline, sequence, sharding  # noqa
        from mast3r_slam_torch.parallel import train, trainer
        batch = trainer.synthetic_pair_batch(rng, 1, 48, 64, 4)
        tiny = trainer.trainer_model(0, device="cpu")
        loss, _ = train.mast3r_loss(tiny.net, batch)
        loss.backward()
        assert bool(torch.isfinite(loss)) and tiny.net.enc_blocks[0].attn.qkv.weight.grad is not None
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "mast3r_slam_tpu"))
        print("FOREIGN", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FOREIGN []" in proc.stdout


def test_slam_loop_and_probe_import_no_jax():
    """Run the port's SLAM loop (tiny model, CPU, chained windows, the
    native host pipeline) and the probe entry point in a fresh interpreter;
    then neither jax nor mast3r_slam_tpu may be in sys.modules."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from mast3r_slam_torch import probe_shift
        from mast3r_slam_torch.config import Config, set_config
        from mast3r_slam_torch.dataloader import Dataset
        from mast3r_slam_torch.models import MASt3RModel
        from mast3r_slam_torch.slam import SLAM
        from mast3r_slam_torch.workload import BENCH_SETTINGS, drift_frames

        class Frames(Dataset):
            def __init__(self, imgs):
                self.imgs = imgs
            def __len__(self):
                return len(self.imgs)
            def __getitem__(self, i):
                return float(i), self.imgs[i]

        settings = dict(BENCH_SETTINGS, runtime={"sync_every": 2, "keyframe_capacity": 4})
        set_config(Config.from_dict(settings))
        model = MASt3RModel.create(model_type="tiny", resolution=64, device="cpu")
        rng = np.random.default_rng(0)
        base = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
        imgs = list((drift_frames(base, 5, rng) * 255).astype(np.uint8))
        res = SLAM(model=model, resolution=64).run(Frames(imgs))
        assert res["poses"].shape == (5, 4, 4) and np.isfinite(res["poses"]).all()
        assert probe_shift.main(["cpu"]) == 0
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "mast3r_slam_tpu"))
        print("FOREIGN", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FOREIGN []" in proc.stdout


def test_port_sources_do_not_name_jax():
    """No module of the port, nor chip_smoke.py, imports jax or the JAX package."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "mast3r_slam_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            for line in f:
                stripped = line.strip()
                if stripped.startswith(("import ", "from ")):
                    mod = stripped.split()[1]
                    assert mod.split(".")[0] not in ("jax", "flax", "mast3r_slam_tpu"), (
                        f"{path}: {stripped}")
