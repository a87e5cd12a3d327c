"""`SLAM.run` of the port in calibration-free mode (the shape of
configs/euroc_nocalib.yaml: `use_calib` with no `dataset.calib`, the dense
matcher) against the JAX package's on the tiny model: the focal is estimated
from the first keyframe's mono pointmap, then the chained tracker and the
backend run the calibrated objectives with it. Every tracked frame is
promoted and the arena holds 4 keyframes. The dense matcher runs at radius
2 (euroc_nocalib.yaml's radius 6 over dilations (2, 1) is 289 taps, which
the JAX package takes minutes to compile on a CPU); both solves take a
half-pixel border, as in test_torch_calib_slam_run.py.

Bands: keyframe frame ids, events and edge lists exact; the focal within
1e-3 relative of JAX's, and within 1e-5 of JAX's estimate from the same
pointmap (measured 3.3e-4 between the runs: on random weights the focal is
ill-conditioned, since pixels whose depth crosses zero leave or join the
median's count when the two models' pointmaps differ by 2e-6 relative;
ROADMAP queue 3); poses within 1e-3 (measured 4.2e-4, following the focal).
"""

import jax.numpy as jnp
import numpy as np
import torch

from mast3r_slam_tpu.utils.intrinsics import estimate_intrinsics as jax_intrinsics
from mast3r_slam_torch import slam as slam_mod
from mast3r_slam_torch.utils.intrinsics import estimate_intrinsics
from test_torch_helpers import run_tiny_slam_pair


def test_slam_run_calibration_free_matches_jax(monkeypatch):
    first = []

    def recording(X, img_size, C):
        first.append((X.clone(), C.clone()))
        return estimate_intrinsics(X, img_size, C)

    monkeypatch.setattr(slam_mod, "estimate_intrinsics", recording)
    n = 5
    jslam, jres, tslam, tres = run_tiny_slam_pair(
        {"use_calib": True, "matching": {"method": "dense", "dense_radius": 2,
                                         "dense_dilations": [1]},
         "tracking": {"match_frac_thresh": 1.0, "pixel_border": 0.5},
         "local_opt": {"pixel_border": 0.5}, "runtime": {"keyframe_capacity": 4}}, n)
    assert len(first) == 1  # estimated once, at init
    K, jK = tslam.keyframes.K, np.asarray(jslam.keyframes.K)
    assert K.shape == (3, 3) and tslam.factor_graph.K is K
    np.testing.assert_allclose(K.numpy(), jK, rtol=1e-3, atol=0)
    X, C = first[0]
    h, w = tslam.keyframes.h, tslam.keyframes.w
    same = np.asarray(jax_intrinsics(jnp.asarray(X.numpy()), (h, w), jnp.asarray(C.numpy())))
    np.testing.assert_allclose(K.numpy(), same, rtol=1e-5, atol=0)
    assert tres["keyframe_indices"] == jres["keyframe_indices"]
    ev = tslam.events
    assert ev["init"] == 1 and ev["chained_step"] == n - 1 and ev["backend_solve"] == n
    assert ev["chained_promotion"] == n - 1 and ev["eviction"] == 1
    e = jslam.factor_graph.n_edges
    assert tslam.factor_graph.n_edges == e > 0
    np.testing.assert_array_equal(tslam.factor_graph.ii[:e], jslam.factor_graph.ii[:e])
    np.testing.assert_array_equal(tslam.factor_graph.jj[:e], jslam.factor_graph.jj[:e])
    np.testing.assert_allclose(tres["poses"], jres["poses"], atol=1e-3, rtol=0)
    assert np.isfinite(tres["poses"]).all() and torch.isfinite(K).all()
