"""The oracle world of tests/test_system_oracle.py (a perfect two-view model,
a smooth trajectory) through the port's SLAM loop with `matching.method:
iterative` (projective matching from the tracker's warm start, descriptor
refinement, the 3D gate; identity starts in the backend), against the JAX
`SLAM` driven the same way (test_torch_loop_closure.py's `_run_both`).

Bands (those of tests/test_torch_slam.py): per-frame modes and keyframe
frame ids exact, no relocalisation; poses within 1e-4 of JAX's; ATE < 5e-3
and max error < 2e-2 against the truth (test_system_oracle.py).
"""

import numpy as np

from mast3r_slam_torch.utils.export import ate_rmse
from test_torch_loop_closure import _run_both
from test_torch_slam import ORACLE_SETTINGS
from tests.oracle import make_oracle_world, render_frame_image


def test_oracle_world_with_the_iterative_matcher_matches_jax():
    rng = np.random.default_rng(42)
    h = w = 16
    n = 6  # 3 promotions: the backend decodes 1, 2 and 3 pairs at once
    model, poses_gt = make_oracle_world(rng, n, h, w, step=0.03)
    frames = [render_frame_image(i, h, w, rng) for i in range(n)]
    settings = dict(ORACLE_SETTINGS, matching={"method": "iterative", "dense_radius": 2,
                                               "dist_thresh": 0.5})
    (j_poses, j_modes, j_reloc), (t_poses, t_modes, t_reloc), jslam, tslam = _run_both(
        model, frames, settings)

    assert t_modes == j_modes and t_reloc == j_reloc == []
    assert list(tslam.keyframes.frame_ids) == list(jslam.keyframes.frame_ids)
    assert len(tslam.keyframes) >= 2 and tslam.events["backend_solve"] >= 2
    np.testing.assert_allclose(t_poses, j_poses, atol=1e-4, rtol=0)
    ate = ate_rmse(t_poses, poses_gt)
    assert ate < 5e-3, f"ATE {ate}"
    err = np.linalg.norm(t_poses[:, :3] - poses_gt[:, :3], axis=-1)
    assert err.max() < 2e-2, f"max abs err {err.max()}"
