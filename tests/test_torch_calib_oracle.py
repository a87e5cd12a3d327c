"""The port's calibration-free SLAM loop against the JAX `SLAM` on the oracle
world of tests/test_system_oracle.py `TestCalibFreeOracle` (a perfect
two-view model, 32x32 frames, use_calib with no intrinsics given): the focal
is estimated from the first mono pointmap, then the synchronous tracker (the
legacy `match_fn` path, `_track_core_calib`) and the calibrated backend solve
run with it. Driven frame by frame as test_torch_slam.py drives the rays
loop.

Bands: the estimated focal within 1e-4 relative of JAX's and within 15% of
the world's (the JAX test's band); per-frame modes and keyframe frame ids
exact; poses within 1e-4 of JAX's; ATE < 5e-2 (the JAX test's band: the
oracle's pointmaps index scene points by frame 0's grid, which the snap to
the pixel rays distorts). The run uses a half-pixel border in both solves:
with an integer border, a frame at its keyframe's pose projects its
ray-constrained points exactly onto the border's pixel column, where f32
rounding decides the gate and the two packages part (ROADMAP queue 3).
"""

import numpy as np

from mast3r_slam_tpu.config import Config as JaxConfig
from mast3r_slam_tpu.config import set_config as jax_set_config
from mast3r_slam_tpu.frame import Mode as JaxMode
from mast3r_slam_tpu.frame import create_frame as jax_create_frame
from mast3r_slam_tpu.slam import SLAM as JaxSLAM
from mast3r_slam_torch import config as torch_config
from mast3r_slam_torch.frame import Mode, create_frame
from mast3r_slam_torch.slam import SLAM
from mast3r_slam_torch.utils.export import ate_rmse
from test_torch_slam import TorchOracle, _drive
from tests.oracle import make_oracle_world, render_frame_image

SETTINGS = {
    "use_calib": True,
    "runtime": {"keyframe_capacity": 16},
    "local_opt": {"max_edges": 32, "pixel_border": 0.5},
    "matching": {"use_simple": True, "dist_thresh": 0.5},
    "tracking": {"match_frac_thresh": 0.95, "pixel_border": 0.5},
}


def test_calibration_free_oracle_matches_jax():
    h = w = 32
    n = 8
    rng = np.random.default_rng(42)
    model, poses_gt = make_oracle_world(rng, n, h, w, step=0.03)
    frames = [render_frame_image(i, h, w, rng) for i in range(n)]

    jax_set_config(JaxConfig.from_dict(SETTINGS))
    jslam = JaxSLAM(model=model, resolution=32)
    j_poses, j_modes = _drive(jslam, frames, JaxMode,
                              lambda i, img: jax_create_frame(i, img), np.asarray)
    torch_config.set_config(torch_config.Config.from_dict(SETTINGS))
    try:
        tslam = SLAM(model=TorchOracle(model), resolution=32)
        assert tslam.keyframes is None  # K comes only with the first frame
        t_poses, t_modes = _drive(tslam, frames, Mode, lambda i, img: create_frame(i, img),
                                  lambda T: T.numpy())
    finally:
        torch_config.reset_config()

    f_j = float(np.asarray(jslam.keyframes.get_intrinsics())[0, 0])
    K = tslam.keyframes.get_intrinsics()
    assert K is not None and K.shape == (3, 3) and tslam.factor_graph.K is K
    f_t = float(K[0, 0])
    assert abs(f_t - f_j) <= 1e-4 * abs(f_j), (f_t, f_j)
    assert abs(f_t - 1.2 * w) < 0.15 * 1.2 * w  # the oracle's focal
    assert t_modes == j_modes
    assert list(tslam.keyframes.frame_ids) == list(jslam.keyframes.frame_ids)
    assert len(tslam.keyframes) >= 2
    np.testing.assert_allclose(t_poses, j_poses, atol=1e-4, rtol=0)
    assert ate_rmse(t_poses, poses_gt) < 5e-2
