"""`SLAM.run` of the port with the window program's knobs on
(`runtime.window_spec_decode`, `window_batched_encode`,
`window_decode_microbatch`) against the JAX package's run with the same
knobs, on the tiny model through `FrameTracker.dispatch_window`
(tests/test_torch_window_knobs.py holds the window program itself).
"""

import numpy as np

from test_torch_helpers import run_tiny_slam_pair


def test_slam_run_with_spec_decode_matches_jax():
    """`SLAM.run` with both knobs on (microbatch 1: each K = 2 window decodes
    in two chunks) under tests/test_torch_slam_run.py's setting (every
    tracked frame promoted, an arena of 4), against JAX's run with the same
    knobs: keyframes, edges and the chained steps exact; poses within
    test_torch_slam_run's 5e-4 up to its third backend solve."""
    n = 6
    jslam, jres, tslam, tres = run_tiny_slam_pair(
        {"tracking": {"match_frac_thresh": 1.0},
         "runtime": {"keyframe_capacity": 4, "window_spec_decode": True,
                     "window_batched_encode": True, "window_decode_microbatch": 1}}, n)
    assert tres["keyframe_indices"] == jres["keyframe_indices"]
    ev = tslam.events
    assert ev["chained_step"] == ev["chained_promotion"] == n - 1
    e = jslam.factor_graph.n_edges
    np.testing.assert_array_equal(tslam.factor_graph.ii[:e], jslam.factor_graph.ii[:e])
    np.testing.assert_array_equal(tslam.factor_graph.jj[:e], jslam.factor_graph.jj[:e])
    np.testing.assert_allclose(tres["poses"][:4], jres["poses"][:4], atol=5e-4, rtol=0)
    assert np.isfinite(tres["poses"]).all()
