"""`python -m mast3r_slam_torch.slam <dir> --config configs/eurocalib.yaml` (and
euroc_nocalib.yaml) on the CPU with the tiny model (patched in for the
random mast3r_full weights): a EuRoC-layout folder of 752x480 grayscale PNG
frames (mav0/cam0/data/<ns>.png) through the host pipeline, the calibrated
loop and the trajectory export. Both configs run as they are; the backend
solves in calib mode only, the arena holds K (the config's, or the focal
estimated at init) and the trajectory is finite with EuRoC's timestamps.
And how `SLAM` installs a known K (`dataset.calib`, rescaled for
`img_downsample`), against the JAX `SLAM`: within 1e-7 relative.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mast3r_slam_torch import config as torch_config
from mast3r_slam_torch.global_opt import FactorGraph
from test_torch_helpers import both_configs, tiny_pair

REPO = Path(__file__).resolve().parents[1]
CALIB = [40.0, 40.5, 31.5, 23.5]  # fx, fy, cx, cy of the tiny model's 64x48 frames


@pytest.mark.parametrize("config", ["eurocalib.yaml", "euroc_nocalib.yaml"])
def test_command_line_runs_euroc_configs(config, tmp_path, monkeypatch):
    from PIL import Image

    from mast3r_slam_torch import slam as slam_mod
    from mast3r_slam_torch.models import MASt3RModel
    from mast3r_slam_torch.utils.export import load_trajectory_tum
    from mast3r_slam_torch.workload import drift_frames

    def tiny(**kw):
        assert kw["model_type"] == "mast3r_full" and kw["checkpoint"] is None
        return MASt3RModel.create(model_type="tiny", resolution=64, device=kw["device"])

    slams, solves = [], []
    init, calib = slam_mod.SLAM.__init__, FactorGraph.solve_GN_calib
    monkeypatch.setattr(slam_mod, "load_mast3r", tiny)
    monkeypatch.setattr(slam_mod.SLAM, "__init__",
                        lambda self, *a, **k: (slams.append(self), init(self, *a, **k))[1])
    monkeypatch.setattr(FactorGraph, "solve_GN_calib",
                        lambda self: (solves.append(1), calib(self))[1])
    monkeypatch.setattr(FactorGraph, "solve_GN_rays",
                        lambda self: pytest.fail("a rays solve in calibrated mode"))
    rng = np.random.default_rng(2)
    base = rng.uniform(0, 1, (480, 752, 3)).astype(np.float32)
    data = tmp_path / "MH_01" / "mav0" / "cam0" / "data"
    data.mkdir(parents=True)
    stamps_ns = [1403636579763555584 + 50_000_000 * i for i in range(4)]
    for ns, img in zip(stamps_ns, drift_frames(base, 4, rng)):
        Image.fromarray((img.mean(-1) * 255).astype(np.uint8), mode="L").save(data / f"{ns}.png")
    traj = tmp_path / "traj.txt"
    try:
        assert slam_mod.main([str(tmp_path / "MH_01"), "--config", str(REPO / "configs" / config),
                              "--resolution", "64", "--device", "cpu", "--max-frames", "4",
                              "--save-traj", str(traj)]) == 0
        cfg = torch_config.get_config()
        assert cfg.use_calib and bool(cfg.dataset.calib) == (config == "eurocalib.yaml")
    finally:
        torch_config.reset_config()
    (slam,) = slams
    K = slam.keyframes.get_intrinsics()
    assert K is not None and slam.factor_graph.K is K and np.isfinite(K.numpy()).all()
    if config == "eurocalib.yaml":
        np.testing.assert_allclose(K.numpy()[[0, 1, 0, 1], [0, 1, 2, 2]],
                                   [313.32, 313.95, 248.88, 163.85], rtol=1e-6)
    assert len(solves) == slam.events["backend_solve"] >= 1
    stamps, poses = load_trajectory_tum(traj)
    np.testing.assert_allclose(stamps, np.array(stamps_ns) / 1e9, rtol=1e-12)
    assert np.isfinite(poses).all()


@pytest.mark.parametrize("downsample", [1, 2])
def test_known_intrinsics_are_installed_as_jax_installs_them(downsample):
    """`dataset.calib` in processed-image pixels becomes the arena's [3, 3] K,
    rescaled to the subsampled grid with the pixel-centre rule."""
    from mast3r_slam_tpu.slam import SLAM as JaxSLAM
    from mast3r_slam_torch.slam import SLAM

    settings = {"use_calib": True, "dataset": {"calib": CALIB, "img_downsample": downsample}}
    with both_configs(settings):
        jm, tm = tiny_pair("linear")
        jslam, tslam = JaxSLAM(model=jm, resolution=64), SLAM(model=tm, resolution=64)
        jslam._initialize_state(48, 64)
        tslam._initialize_state(48, 64)
    K = tslam.keyframes.get_intrinsics()
    assert K.dtype == torch.float32 and (tslam.keyframes.h, tslam.keyframes.w) == (
        48 // downsample, 64 // downsample)
    np.testing.assert_allclose(K.numpy(), np.asarray(jslam.keyframes.get_intrinsics()),
                               rtol=1e-7, atol=0)
    assert tslam.factor_graph.K is K and tslam.tracker._calib_live()
