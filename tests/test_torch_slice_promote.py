"""The port's tracking slice vs the JAX chained step with promotion on every
frame (match_frac_thresh 1.0): the host-side branch into the mono decode must
reproduce the JAX lax.cond exactly. Setup and bands: test_torch_slice.py."""

from mast3r_slam_tpu.tracker import EVENT_NEW_KF
from test_torch_slice import assert_slice_matches, run_both


def test_slice_with_promotion_matches_jax():
    ref, ours, n = run_both(1.0)
    assert_slice_matches(ref, ours, n, EVENT_NEW_KF)
    assert float(ours["final"]["kN"]) == 1.0  # a fresh keyframe each frame
