"""The port's SLAM loop against the JAX `SLAM` on the oracle world of
tests/oracle.py (a perfect two-view model over a synthetic surface and a
smooth trajectory), driven frame by frame as tests/test_system_oracle.py
drives the JAX loop: INIT, synchronous tracking through the legacy
`match_fn` path with the dense matcher, promotions, backend solves.

The port runs the oracle through `TorchOracle`, a wrapper of the JAX
package's `OracleModel` that hands it numpy and returns torch tensors.
Bands: keyframe frame ids and per-frame modes exact; poses within 1e-4 of
JAX's; ATE < 5e-3 and max absolute error < 2e-2 against the ground truth,
the bands of test_system_oracle.py.
"""

import numpy as np
import pytest
import torch

from mast3r_slam_tpu.config import Config as JaxConfig
from mast3r_slam_tpu.config import set_config as jax_set_config
from mast3r_slam_tpu.frame import Mode as JaxMode
from mast3r_slam_tpu.frame import create_frame as jax_create_frame
from mast3r_slam_tpu.slam import SLAM as JaxSLAM
from mast3r_slam_torch import config as torch_config
from mast3r_slam_torch.frame import Mode, create_frame
from mast3r_slam_torch.slam import SLAM
from mast3r_slam_torch.utils.export import ate_rmse
from tests.oracle import make_oracle_world, render_frame_image

ORACLE_SETTINGS = {
    "runtime": {"keyframe_capacity": 16},
    "local_opt": {"max_edges": 32},
    "matching": {"method": "dense", "dense_radius": 2, "dist_thresh": 0.5},
    "tracking": {"match_frac_thresh": 0.95},
}


def _t(a):
    return torch.from_numpy(np.array(a))


class TorchOracle:
    """The oracle two-view model behind the port's model interface."""

    def __init__(self, oracle):
        self.oracle = oracle
        self.device = torch.device("cpu")
        self.embed_dim = oracle.embed_dim
        self.patch_size = oracle.patch_size

    def encode(self, img):
        feat, pos = self.oracle.encode(img.numpy())
        return _t(feat), _t(pos)

    def decode(self, f1, pos1, f2, pos2):
        outs = self.oracle.decode(f1.numpy(), pos1.numpy(), f2.numpy(), pos2.numpy())
        return tuple({k: _t(v) for k, v in out.items()} for out in outs)

    def mono(self, feat, pos):
        X, C = self.oracle.mono(feat.numpy(), pos.numpy())
        return _t(X), _t(C)


def _drive(slam, frames, mode_enum, make_frame, pose_np):
    """test_system_oracle.py's loop: one synchronous step per frame and a
    backend drain after it -> (poses [F, 8], modes before each frame)."""
    poses, modes = [], []
    for i, img in enumerate(frames):
        frame = make_frame(i, img)
        if i == 0:
            slam._initialize_state(img.shape[0], img.shape[1])
        modes.append(slam.state.mode.name)
        if slam.state.mode == mode_enum.INIT:
            slam._process_init(frame)
        elif slam.state.mode == mode_enum.TRACKING:
            slam._process_tracking(frame)
        else:
            slam._process_reloc(frame)
        poses.append(pose_np(frame.T_WC))
        slam._run_backend()
    return np.stack(poses), modes


@pytest.mark.parametrize("step,thresh", [(0.03, 0.95), (0.12, 0.9)])
def test_oracle_slam_matches_jax(step, thresh):
    h = w = 16
    n = 12
    rng = np.random.default_rng(42)
    model, poses_gt = make_oracle_world(rng, n, h, w, step=step)
    frames = [render_frame_image(i, h, w, rng) for i in range(n)]
    settings = dict(ORACLE_SETTINGS, tracking={"match_frac_thresh": thresh})
    if step > 0.05:  # the drifting world of test_keyframes_created_on_drift
        settings["matching"] = dict(settings["matching"], dist_thresh=0.05)
        settings["tracking"] = dict(settings["tracking"], min_match_frac=0.01)

    jax_set_config(JaxConfig.from_dict(settings))
    jslam = JaxSLAM(model=model, resolution=16)
    j_poses, j_modes = _drive(jslam, frames, JaxMode,
                              lambda i, img: jax_create_frame(i, img), np.asarray)
    torch_config.set_config(torch_config.Config.from_dict(settings))
    try:
        tslam = SLAM(model=TorchOracle(model), resolution=16)
        t_poses, t_modes = _drive(tslam, frames, Mode, lambda i, img: create_frame(i, img),
                                  lambda T: T.numpy())
    finally:
        torch_config.reset_config()

    assert t_modes == j_modes
    assert list(tslam.keyframes.frame_ids) == list(jslam.keyframes.frame_ids)
    assert len(tslam.keyframes) >= 2
    np.testing.assert_allclose(t_poses, j_poses, atol=1e-4, rtol=0)
    nk = len(tslam.keyframes)
    np.testing.assert_allclose(tslam.keyframes.T_WC[:nk].numpy(),
                               np.asarray(jslam.keyframes.T_WC[:nk]), atol=1e-4, rtol=0)
    ate = ate_rmse(t_poses, poses_gt)
    abs_err = np.linalg.norm(t_poses[:, :3] - poses_gt[:, :3], axis=-1)
    assert ate < 5e-3, f"ATE {ate}"
    assert abs_err.max() < 2e-2, f"max abs err {abs_err.max()}"
