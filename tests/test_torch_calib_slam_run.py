"""`SLAM.run` of the port in calibrated mode with known intrinsics (the shape
of configs/eurocalib.yaml: `use_calib`, `dataset.calib`, `matching.method`
auto -> the simple matcher) against the JAX package's on the tiny model,
with the windowed chained path on (K=2 windows), every tracked frame
promoted (`match_frac_thresh` above 1) and a keyframe arena of 4, so the
backend runs a calibrated graph solve for every new keyframe and the arena
evicts.

Both solves take a half-pixel border (`pixel_border` 0.5): with an integer
border a frame at its keyframe's pose projects its ray-constrained points
exactly onto the border's pixel column, where f32 rounding decides the gate
and the two packages part by 5e-3 (ROADMAP queue 3); with it the runs agree
at every frame.

Bands: keyframe frame ids, events and the backend's edge lists exact; every
pose within 5e-4 (the band of test_torch_slam_run.py; measured 4e-6).
tests/test_torch_calib_cli.py holds how `SLAM` installs a known K.
"""

import numpy as np
import pytest

from mast3r_slam_torch.global_opt import FactorGraph
from test_torch_helpers import run_tiny_slam_pair

CALIB = [40.0, 40.5, 31.5, 23.5]  # fx, fy, cx, cy of the tiny model's 64x48 frames


def test_slam_run_calibrated_matches_jax(monkeypatch):
    solves = []
    calib = FactorGraph.solve_GN_calib
    monkeypatch.setattr(FactorGraph, "solve_GN_calib",
                        lambda self: (solves.append(1), calib(self))[1])
    monkeypatch.setattr(FactorGraph, "solve_GN_rays",
                        lambda self: pytest.fail("a rays solve in calibrated mode"))
    n = 5
    jslam, jres, tslam, tres = run_tiny_slam_pair(
        {"use_calib": True, "dataset": {"calib": CALIB}, "matching": {"method": "auto"},
         "tracking": {"match_frac_thresh": 1.01, "pixel_border": 0.5},
         "local_opt": {"pixel_border": 0.5}, "runtime": {"keyframe_capacity": 4}}, n)
    np.testing.assert_array_equal(tslam.keyframes.K.numpy(), np.asarray(jslam.keyframes.K))
    np.testing.assert_array_equal(tslam.keyframes.K.numpy()[[0, 1, 0, 1], [0, 1, 2, 2]], CALIB)
    assert tslam.factor_graph.K is tslam.keyframes.K
    assert tres["keyframe_indices"] == jres["keyframe_indices"] == [0, 2, 3, 4]
    ev = tslam.events
    assert ev["init"] == 1 and ev["eviction"] == 1
    assert ev["chained_step"] == ev["chained_promotion"] == n - 1
    assert ev["backend_solve"] == len(solves) == n
    e = jslam.factor_graph.n_edges
    assert tslam.factor_graph.n_edges == e > 0
    np.testing.assert_array_equal(tslam.factor_graph.ii[:e], jslam.factor_graph.ii[:e])
    np.testing.assert_array_equal(tslam.factor_graph.jj[:e], jslam.factor_graph.jj[:e])
    np.testing.assert_allclose(tres["poses"], jres["poses"], atol=5e-4, rtol=0)
    assert np.abs(tres["poses"][-1] - tres["poses"][0]).max() > 1e-3  # the poses moved
    assert np.isfinite(tres["points"]).all()
