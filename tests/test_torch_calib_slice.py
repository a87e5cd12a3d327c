"""The port's chained tracking step in calibrated mode against the JAX chained
step `_make_fused_track_chain(use_calib=True)` on the tiny model: the same
tiny weights, the same numpy-seeded frames drifting 2 px per frame, the same
intrinsics. The port runs through its arena path (`FrameTracker` over a
`Keyframes` arena holding K, `test_torch_helpers.arena_tracker`, and
`dispatch_window`), so the calibrated step is picked per step by
`_calib_live`.

Two settings: (a) the eurocalib shape, the simple matcher (`method: auto`
with `use_simple`) and no promotion; (b) the euroc_nocalib shape, the dense
matcher at radius 6, promoting every frame.

Bands: events and fusion counts exact; match_frac / match_frac_k /
unique_frac_f within 0.02; poses within 5e-3. The poses are looser than the
rays slice's 5e-4 because of the calibrated pose solve's strict border gate
(u > border, u < w-1-border): at T_CkCf near the identity the ray-constrained
points project onto the pixel grid itself, and whether the image-edge pixels
count is decided by f32 rounding, which differs between the two packages
(measured 3.1e-4 (a) and 2.4e-3 (b) on these frames; on generic poses the
solve agrees within 5e-6, tests/test_torch_calib_ops.py).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.frame import create_frame as jax_create_frame
from mast3r_slam_tpu.inference import mast3r_inference_mono as jax_mono
from mast3r_slam_tpu.tracker import EVENT_NEW_KF, EVENT_TRACKED, _make_fused_track_chain
from mast3r_slam_torch.frame import create_frame
from mast3r_slam_torch.workload import drift_frames
from test_torch_helpers import BENCH_SETTINGS, arena_tracker, both_configs, tiny_pair

N_FRAMES = 4
SETTINGS = {
    "simple": ({"method": "auto", "use_simple": True}, 0.0, EVENT_TRACKED),
    "dense": ({"method": "dense", "dense_radius": 6, "dense_dilations": [1]}, 1.0, EVENT_NEW_KF),
}


@pytest.mark.parametrize("matcher", ["simple", "dense"])
def test_calib_chained_step_matches_jax(matcher):
    matching, thresh, event = SETTINGS[matcher]
    settings = copy.deepcopy(BENCH_SETTINGS)
    # the 3D gate wide open, as bench.py opens it: the random-weight tiny
    # model's pointmaps span tens of units
    settings.update(use_calib=True, matching=dict(matching, dist_thresh=1e6))
    settings["tracking"]["match_frac_thresh"] = thresh
    with both_configs(settings) as cfg:
        jm, tm = tiny_pair("linear")
        h, w = jm._out_hw
        n = h * w
        K = np.array([[40.0, 0, 31.5], [0, 40.5, 23.5], [0, 0, 1]], np.float32)
        rng = np.random.default_rng(5)
        base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
        imgs = drift_frames(base, N_FRAMES, rng)

        from mast3r_slam_tpu.config import get_config as jax_get_config

        jcfg = jax_get_config().tracking
        chain = _make_fused_track_chain(jm, jcfg, jcfg.filtering_mode, use_calib=True)
        kf = jax_create_frame(0, jnp.asarray(base))
        X, C, feat, pos = jax_mono(jm, kf)
        st = dict(feat=feat, pos=pos, idx=jnp.arange(n, dtype=jnp.int32)[None], X=X, C=C,
                  N=jnp.asarray(1.0), Tp=kf.T_WC, Tk=kf.T_WC)
        ref = []
        for j in range(N_FRAMES):
            out = chain(jm.params, jnp.asarray(imgs[j]), st["feat"], st["pos"], st["idx"],
                        st["X"], st["C"], st["N"], st["Tp"], st["Tk"], jnp.asarray(K))
            ref.append((np.asarray(out["stats"]), np.asarray(out["T_WCf"])))
            st = dict(feat=out["kf_feat"], pos=out["kf_pos"], idx=out["idx"], X=out["kf_X"],
                      C=out["kf_C"], N=out["kN"], Tp=out["T_WCf"], Tk=out["kf_T"])

        tracker = arena_tracker(tm, cfg, base, K)
        frames = [create_frame(j + 1, torch.from_numpy(imgs[j])) for j in range(N_FRAMES)]
        handle = tracker.dispatch_window(frames, torch.from_numpy(imgs))

    stats = handle["out"]["stats"].numpy()
    j_stats = np.stack([s for s, _ in ref])
    np.testing.assert_array_equal(stats[:, 3], j_stats[:, 3])
    assert (stats[:, 3] == event).all(), stats[:, 3]
    np.testing.assert_array_equal(stats[:, 4:], j_stats[:, 4:])
    np.testing.assert_allclose(stats[:, :3], j_stats[:, :3], atol=0.02, rtol=0)
    poses = np.stack([r["T_WCf"].numpy() for r in handle["out"]["rows"]])
    np.testing.assert_allclose(poses, np.stack([T for _, T in ref]), atol=5e-3, rtol=0)
    assert np.abs(poses[-1] - poses[0]).max() > 0  # the frames moved
