"""The port's tracking slice (tracker.FrameTracker) vs the JAX chained step.

The JAX reference is `_make_fused_track_chain` run frame by frame (as
tests/test_window_scan.py drives it), from a keyframe made by
`mast3r_inference_mono`; the port runs `FrameTracker.init_keyframe` and
`dispatch_window` on the CPU. Same tiny weights (flax init carried over), same
numpy-seeded frames drifting 2 px per frame, the deployment matcher and tanh
gelu (configs/base.yaml), gates as bench.py opens them. This file: no
promotion (match_frac_thresh 0); test_torch_slice_promote.py: promotion on
every frame (match_frac_thresh 1).

Bands: events and fusion counts exact; match_frac / match_frac_k /
unique_frac_f within 2/N (one pick of N = 3072 moving: the two models'
f32 outputs differ by ~1e-6 relative, which can tip a near-tie); poses and
the final keyframe pose atol 5e-4 (measured: ~1e-6 where every pick agrees,
1.5e-4 after the one flipped pick of the promotion run below, which the
promoted keyframe pose carries forward); frame and keyframe pointmaps the
per-point band of test_torch_model.py.
"""

import copy

import jax.numpy as jnp
import numpy as np
import torch

from mast3r_slam_tpu.frame import create_frame
from mast3r_slam_tpu.inference import mast3r_inference_mono
from mast3r_slam_tpu.tracker import EVENT_TRACKED, _make_fused_track_chain
from mast3r_slam_torch.tracker import FrameTracker
from test_torch_model import _assert_pts_close
from test_torch_helpers import BENCH_SETTINGS, both_configs, tiny_pair
from test_torch_window_graph_cuda import dispatch, stacked

K = 4


def run_both(match_frac_thresh: float, seed: int = 11):
    settings = copy.deepcopy(BENCH_SETTINGS)
    settings["tracking"]["match_frac_thresh"] = match_frac_thresh
    with both_configs(settings) as cfg:
        jm, tm = tiny_pair("linear")
        h, w = jm._out_hw
        n = h * w
        rng = np.random.default_rng(seed)
        base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
        imgs = np.stack([
            np.clip(np.roll(base, 2 * (j + 1), axis=1) + rng.normal(0, 0.01, base.shape), 0, 1)
            for j in range(K)
        ]).astype(np.float32)

        from mast3r_slam_tpu.config import get_config as jax_get_config

        jcfg = jax_get_config().tracking
        chain = _make_fused_track_chain(jm, jcfg, jcfg.filtering_mode)
        kf = create_frame(0, jnp.asarray(base))
        X, C, feat, pos = mast3r_inference_mono(jm, kf)
        st = dict(feat=feat, pos=pos, idx=jnp.arange(n, dtype=jnp.int32)[None], X=X, C=C,
                  N=jnp.asarray(1.0), Tp=kf.T_WC, Tk=kf.T_WC)
        ref = {"stats": [], "T_WCf": [], "frame_X": []}
        for j in range(K):
            out = chain(jm.params, jnp.asarray(imgs[j]), st["feat"], st["pos"], st["idx"],
                        st["X"], st["C"], st["N"], st["Tp"], st["Tk"], None)
            for key in ref:
                ref[key].append(np.asarray(out[key]))
            st = dict(feat=out["kf_feat"], pos=out["kf_pos"], idx=out["idx"], X=out["kf_X"],
                      C=out["kf_C"], N=out["kN"], Tp=out["T_WCf"], Tk=out["kf_T"])
        ref = {k: np.stack(v) for k, v in ref.items()}
        ref["final"] = {k: np.asarray(v) for k, v in st.items()}

        tracker = FrameTracker(tm, cfg, device="cpu")
        tracker.init_keyframe(base)
        ours = stacked(dispatch(tracker, imgs))
    return ref, ours, n


def assert_slice_matches(ref, ours, n, event):
    stats = ours["stats"].numpy()
    np.testing.assert_array_equal(stats[:, 3], ref["stats"][:, 3])
    assert (stats[:, 3] == event).all(), stats[:, 3]
    np.testing.assert_array_equal(stats[:, 4:], ref["stats"][:, 4:])
    np.testing.assert_allclose(stats[:, :3], ref["stats"][:, :3], atol=2.0 / n, rtol=0)
    np.testing.assert_allclose(ours["T_WCf"].numpy(), ref["T_WCf"], atol=5e-4, rtol=0)
    for j in range(K):
        _assert_pts_close(ours["frame_X"][j].numpy(), ref["frame_X"][j], f"frame {j}")
    final = ours["final"]
    _assert_pts_close(final["kf_X"].numpy(), ref["final"]["X"], "final keyframe")
    np.testing.assert_allclose(final["kf_C"].numpy(), ref["final"]["C"], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(final["kf_T"].numpy(), ref["final"]["Tk"], atol=5e-4, rtol=0)
    np.testing.assert_array_equal(final["idx"].numpy(), ref["final"]["idx"])
    assert float(final["kN"]) == float(ref["final"]["N"])


def test_slice_without_promotion_matches_jax():
    ref, ours, n = run_both(0.0)
    assert_slice_matches(ref, ours, n, EVENT_TRACKED)
    assert float(ours["final"]["kN"]) == 1 + K  # the keyframe fused every frame
