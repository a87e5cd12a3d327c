"""`python -m mast3r_slam_torch.slam <dir> --config configs/tum.yaml` (then
sevenscenes.yaml, and fast.yaml with `--model-type dunemast3r`) on the CPU,
over a folder of 640x480 PNG frames, with the model patched to a tiny one
(patch 16, or patch 14 for the dunemast3r family) in place of the random
full-width weights.

Each config runs as written: tum.yaml and sevenscenes.yaml build the ASMK
database (`retrieval.method: asmk`, 256 words of 64 dims) and match with the
dense lattice, fast.yaml builds the dunemast3r model and the simple matcher;
the trajectory is finite, one pose per frame. A random tiny model tracks
none of these frames at the configs' gates (every frame relocalises and
fails), so the same command then runs tum.yaml and fast.yaml under a config
that inherits them and opens the tracking gates, as the card's smoke run
does: every frame is promoted, and the backend solves. Under tum.yaml the
ASMK codebook is fitted at the 8th keyframe and answers the queries after
it; under fast.yaml every graph solve runs at `point_stride` 2.
"""

from pathlib import Path

import numpy as np
import pytest

from mast3r_slam_torch import config as torch_config
from mast3r_slam_torch import global_opt

REPO = Path(__file__).resolve().parents[1]
CASES = {  # config -> (extra arguments, model type, patch, retrieval, matcher, k, stride)
    "tum.yaml": ([], "mast3r_full", 16, "asmk", "dense", 3, 1),
    "sevenscenes.yaml": ([], "mast3r_full", 16, "asmk", "dense", 5, 1),
    "fast.yaml": (["--model-type", "dunemast3r"], "dunemast3r", 14, "signature", "auto", 3, 2),
}
OPEN_GATES = """
matching:
  dist_thresh: 1000000.0
tracking:
  min_match_frac: 0.0
  Q_conf: 0.0
  match_frac_thresh: 1.01
"""


def run_command_line(tmp_path, monkeypatch, config: Path, n: int, case: str):
    """The command line over n drifting 640x480 PNG frames -> (the SLAM,
    its config, the point strides of its graph solves, the ASMK queries)."""
    from PIL import Image

    from mast3r_slam_torch import slam as slam_mod
    from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel, asmk
    from mast3r_slam_torch.utils.export import load_trajectory_tum
    from mast3r_slam_torch.workload import drift_frames

    extra, model_type, patch = CASES[case][:3]

    def tiny(**kw):
        assert kw["model_type"] == model_type and kw["variant"] == "base"
        assert kw["checkpoint"] is None
        return MASt3RModel.create(cfg=MASt3RConfig.tiny(patch_size=patch),
                                  resolution=kw["resolution"], device=kw["device"])

    slams, strides, queries = [], [], []
    init, graph_solve = slam_mod.SLAM.__init__, global_opt.gauss_newton_graph
    query = asmk.ASMKRetriever.query
    monkeypatch.setattr(slam_mod, "load_mast3r", tiny)
    monkeypatch.setattr(slam_mod.SLAM, "__init__",
                        lambda self, *a, **k: (slams.append(self), init(self, *a, **k))[1])
    monkeypatch.setattr(global_opt, "gauss_newton_graph", lambda *a, **k: (
        strides.append(k["point_stride"]), graph_solve(*a, **k))[1])
    monkeypatch.setattr(asmk.ASMKRetriever, "query",
                        lambda self, *a, **k: (queries.append(self.count), query(self, *a, **k))[1])
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 1, (480, 640, 3)).astype(np.float32)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i, img in enumerate(drift_frames(base, n, rng)):
        Image.fromarray((img * 255).astype(np.uint8)).save(frames / f"{i:04d}.png")
    traj = tmp_path / "traj.txt"
    resolution = 4 * patch  # the tiny model's width: 48x64 (patch 16) or 42x56 (patch 14)
    try:
        assert slam_mod.main([str(frames), "--config", str(config), *extra,
                              "--resolution", str(resolution), "--device", "cpu",
                              "--save-traj", str(traj)]) == 0
        cfg = torch_config.get_config()
    finally:
        torch_config.reset_config()
    (slam,) = slams
    assert slam.model.patch_size == patch and slam.keyframes.w == resolution
    stamps, poses = load_trajectory_tum(traj)
    assert len(stamps) == n and np.isfinite(poses).all()
    return slam, cfg, strides, queries


@pytest.mark.parametrize("config", list(CASES))
def test_command_line_runs_each_config_as_written(config, tmp_path, monkeypatch):
    n = 3
    slam, cfg, _, _ = run_command_line(tmp_path, monkeypatch, REPO / "configs" / config, n,
                                       config)
    _, _, _, method, matcher, k, stride = CASES[config]
    assert cfg.retrieval.method == method and cfg.retrieval.k == k
    assert cfg.matching.method == matcher and cfg.local_opt.point_stride == stride
    db = slam.retrieval_db
    assert (db.asmk is not None) == (method == "asmk")
    if db.asmk is not None:
        assert db.asmk.B.shape == (512, 256, 64) and db._asmk_codebook_kf == 8
        # fewer keyframes than the codebook needs: their tokens are held
        assert len(db._asmk_pending) == len(slam.keyframes) < 8 and not db.asmk.ready()
    assert slam.events["reloc"] == n - 1  # random weights track nothing at these gates


def test_tum_config_fits_asmk_at_the_8th_keyframe(tmp_path, monkeypatch):
    config = tmp_path / "tum_open.yaml"
    config.write_text(f"inherit: {REPO}/configs/tum.yaml\n{OPEN_GATES}")
    n = 9
    slam, cfg, strides, queries = run_command_line(tmp_path, monkeypatch, config, n, "tum.yaml")
    assert cfg.retrieval.method == "asmk" and cfg.matching.method == "dense"
    assert len(slam.keyframes) == n and slam.events["reloc"] == 0
    db = slam.retrieval_db
    assert db.asmk.ready() and db._asmk_fit_size == 8 and db.asmk.count == n
    assert queries == [8]  # the 9th keyframe queries ASMK before its insertion
    assert set(strides) == {1} and len(strides) == slam.events["backend_solve"] - 1


def test_fast_config_solves_at_point_stride_2(tmp_path, monkeypatch):
    config = tmp_path / "fast_open.yaml"
    config.write_text(f"inherit: {REPO}/configs/fast.yaml\n{OPEN_GATES}")
    n = 4
    slam, cfg, strides, _ = run_command_line(tmp_path, monkeypatch, config, n, "fast.yaml")
    assert slam.model.cfg.enc_embed_dim == 64 and cfg.model.model_type == "dunemast3r"
    assert len(slam.keyframes) == n and slam.factor_graph.n_edges >= n - 1
    assert strides and set(strides) == {2}
