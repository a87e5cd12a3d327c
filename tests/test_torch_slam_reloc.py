"""`SLAM.run` of the port against the JAX package's on the tiny model, with
the windowed chained path on (K=2 windows), under setting (ii) of the card's
smoke run: `min_match_frac` 1.01, so every tracked frame skips into RELOC
(retrieval, a tentative keyframe, `add_factors(is_reloc=...)` and a graph
solve; `reloc.min_match_frac` 0 so that it succeeds), and the frames after a
skip replay synchronously.

Bands: keyframe frame ids and events exact; the per-frame poses, recorded
as each frame is resolved, within 1e-4 (measured 1.6e-5). The arena's
keyframe poses after the last backend solve within 1e-2 (measured 7.1e-3):
on this random-weight model the graph solve is ill-conditioned and turns the
1e-6 differences of its inputs into ~1e-2 in JAX itself (see
test_torch_slam_run.py; the solve is held to JAX on identical inputs at 1e-5
in test_torch_graph_gn.py).
"""

import numpy as np

from test_torch_helpers import run_tiny_slam_pair


def test_slam_run_relocalises_every_frame():
    n = 6
    jslam, jres, tslam, tres = run_tiny_slam_pair(
        {"tracking": {"min_match_frac": 1.01}, "reloc": {"min_match_frac": 0.0}}, n)
    assert tres["keyframe_indices"] == jres["keyframe_indices"] == list(range(n))
    ev = tslam.events
    assert ev["init"] == 1 and ev["reloc"] == ev["reloc_solve"] == n - 1
    assert ev["chained_step"] + ev["sync_step"] >= n - 1
    np.testing.assert_allclose(tres["poses"], jres["poses"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tslam.keyframes.T_WC[:n].numpy(),
                               np.asarray(jslam.keyframes.T_WC[:n]), atol=1e-2, rtol=0)
    assert np.isfinite(tres["points"]).all()
