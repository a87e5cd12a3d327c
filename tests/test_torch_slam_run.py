"""`SLAM.run` of the port against the JAX package's on the tiny model, with
the windowed chained path on (K=2 windows), under setting (i) of the card's
smoke run: `match_frac_thresh` 1.0 (every tracked frame is promoted inside
the chained step) and a keyframe arena of 4, so the backend solves each new
keyframe against up to three earlier ones and the arena evicts.

Bands: per-frame modes, keyframe frame ids and the backend's edge lists
exact. Poses within 5e-4 of JAX's for the frames tracked before the third
backend solve (measured 1.3e-4). After it the two runs part: on this
random-weight model the graph solve is ill-conditioned, and JAX's own solve
turns the 4e-6 difference of its inputs into 6e-3 (measured; the solve is
held to JAX on identical inputs in test_torch_graph_gn.py), so the later
poses are checked for finiteness only.
"""

import os

import numpy as np

from mast3r_slam_torch import config as torch_config
from test_torch_helpers import run_tiny_slam_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_slam_run_promotes_every_frame_and_evicts():
    n = 8
    jslam, jres, tslam, tres = run_tiny_slam_pair(
        {"tracking": {"match_frac_thresh": 1.0}, "runtime": {"keyframe_capacity": 4}}, n)
    assert tres["keyframe_indices"] == jres["keyframe_indices"] == [0, 5, 6, 7]
    ev = tslam.events
    assert ev["init"] == 1 and ev["eviction"] == 4
    assert ev["chained_step"] == ev["chained_promotion"] == n - 1
    assert ev["backend_solve"] == n
    e = jslam.factor_graph.n_edges
    np.testing.assert_array_equal(tslam.factor_graph.ii[:e], jslam.factor_graph.ii[:e])
    np.testing.assert_array_equal(tslam.factor_graph.jj[:e], jslam.factor_graph.jj[:e])
    assert tres["poses"].shape == jres["poses"].shape == (n, 4, 4)
    np.testing.assert_allclose(tres["poses"][:6], jres["poses"][:6], atol=5e-4, rtol=0)
    assert np.isfinite(tres["poses"]).all() and np.isfinite(tres["points"]).all()
    np.testing.assert_array_equal(tres["timestamps"], jres["timestamps"])


def test_command_line_runs_a_folder_and_exports(tmp_path, monkeypatch):
    """`python -m mast3r_slam_torch.slam <dir>` on the CPU with the tiny model
    (patched in for the random mast3r_full weights): a folder of PNG frames
    through the host pipeline, the loop, and both exports."""
    from PIL import Image

    from mast3r_slam_torch import slam as slam_mod
    from mast3r_slam_torch.models import MASt3RModel
    from mast3r_slam_torch.utils.export import load_trajectory_tum
    from mast3r_slam_torch.workload import drift_frames

    def tiny(**kw):
        assert kw["model_type"] == "mast3r_full" and kw["checkpoint"] is None
        return MASt3RModel.create(model_type="tiny", resolution=64, device=kw["device"])

    monkeypatch.setattr(slam_mod, "load_mast3r", tiny)
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i, img in enumerate(drift_frames(base, 5, rng)):
        Image.fromarray((img * 255).astype(np.uint8)).save(frames / f"{i:04d}.png")
    traj, ply = tmp_path / "traj.txt", tmp_path / "map.ply"
    config = tmp_path / "port.yaml"  # the README's: TUM settings, signature retrieval
    config.write_text(f"inherit: {REPO}/configs/tum.yaml\nretrieval:\n  method: signature\n")
    assert slam_mod.main([str(frames), "--config", str(config), "--resolution", "64",
                          "--device", "cpu",
                          "--max-frames", "4", "--save-traj", str(traj),
                          "--save-ply", str(ply)]) == 0
    torch_config.reset_config()
    stamps, poses = load_trajectory_tum(traj)
    assert stamps.tolist() == [0.0, 1.0, 2.0, 3.0] and np.isfinite(poses).all()
    assert ply.read_bytes().startswith(b"ply")
