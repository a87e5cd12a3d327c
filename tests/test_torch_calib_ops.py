"""Calibrated mode's parts in the port against the JAX package, on the same
numpy-seeded inputs: intrinsics estimation (utils/intrinsics.py), the simple
matcher (matching.py), the pixel + log-depth pose GN
(`gauss_newton_pose_calib`), the calib and points graph solves
(`gauss_newton_graph`) and the calibrated tracking core
(`tracker._track_core_calib`).

Bands: the focal 1e-5 relative (the median is JAX's own arithmetic; the
Weiszfeld sums run in another order); the simple matcher exact; the pose
solve and the tracking core those of test_torch_gauss_newton.py and
test_torch_tracker_core.py (pose atol 1e-5, cost rtol 1e-4, statistics
exact, Xkk atol 1e-4); the graph solves 1e-5, as the rays parity tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.config import TrackingConfig as JaxTrackingConfig
from mast3r_slam_tpu.geometry import constrain_points_to_ray as jax_constrain
from mast3r_slam_tpu.lie import core as jlie
from mast3r_slam_tpu.matching import match_simple as jax_match_simple
from mast3r_slam_tpu.ops import gauss_newton as jgn
from mast3r_slam_tpu.tracker import _calib_cfg_key as jax_cfg_key
from mast3r_slam_tpu.tracker import _track_core_calib as jax_core
from mast3r_slam_tpu.utils.intrinsics import estimate_focal as jax_focal
from mast3r_slam_tpu.utils.intrinsics import estimate_intrinsics as jax_intrinsics
from mast3r_slam_torch.config import TrackingConfig
from mast3r_slam_torch.geometry import backproject, constrain_points_to_ray, decompose_K
from mast3r_slam_torch.matching import match, match_simple
from mast3r_slam_torch.ops import gauss_newton as gn
from mast3r_slam_torch.tracker import _calib_cfg_key, _track_core_calib
from mast3r_slam_torch.utils.intrinsics import _nanmedian, estimate_focal, estimate_intrinsics
from test_torch_helpers import both_configs
from tests.fixtures import camera_K, make_graph_problem, perturb_poses, world_surface


def _t(a):
    return torch.from_numpy(np.array(a))


# -- intrinsics ---------------------------------------------------------------


@pytest.mark.parametrize("n_valid", [7, 8, 0])
def test_nanmedian_is_jax_nanmedian(n_valid):
    """JAX's median (the mean of the two middle values of an even count), not
    torch.nanmedian's lower middle value; NaN when nothing is valid."""
    rng = np.random.default_rng(n_valid)
    x = np.full(12, np.nan, np.float32)
    x[rng.permutation(12)[:n_valid]] = rng.normal(300, 20, n_valid).astype(np.float32)
    want = np.asarray(jnp.nanmedian(jnp.asarray(x)))
    got = _nanmedian(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    if n_valid == 8:
        assert float(torch.nanmedian(_t(x))) != float(want)  # the trap


def _pointmap(rng, h, w, f_true, outliers=0.05):
    """A camera-frame pointmap seen by a pinhole of focal f_true (principal
    point at the centre), with depth noise, outliers, points behind the
    camera, and a confidence map >= 1."""
    K = np.array([[f_true, 0, w / 2], [0, f_true, h / 2], [0, 0, 1]], np.float32)
    X = world_surface(rng, h, w, K)
    X *= rng.uniform(0.98, 1.02, (h * w, 1)).astype(np.float32)
    bad = rng.uniform(size=h * w) < outliers
    X[bad] += rng.normal(0, 0.5, (bad.sum(), 3)).astype(np.float32)
    X[rng.uniform(size=h * w) < 0.02, 2] = -1.0
    conf = rng.uniform(1.0, 5.0, (h * w, 1)).astype(np.float32)
    return X, conf


@pytest.mark.parametrize("with_conf", [True, False])
@pytest.mark.parametrize("iters", [10, 0])
def test_estimate_focal_matches_jax(with_conf, iters):
    """An even count of valid pixels (where the median rule matters); iters 0
    returns the median start itself."""
    h, w = 24, 32
    X, conf = _pointmap(np.random.default_rng(1), h, w, f_true=38.4)
    ok = (X[:, 2] > 1e-6) & ((conf[:, 0] > 1.0) if with_conf else True)
    if ok.sum() % 2:
        X[np.flatnonzero(ok)[0], 2] = -1.0
    assert ((X[:, 2] > 1e-6) & ((conf[:, 0] > 1.0) if with_conf else True)).sum() % 2 == 0
    c = conf if with_conf else None
    want = float(jax_focal(jnp.asarray(X), (h, w), None if c is None else jnp.asarray(c),
                           iters=iters))
    got = float(estimate_focal(_t(X), (h, w), None if c is None else _t(c), iters=iters))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert abs(got - 38.4) < 0.15 * 38.4  # the estimate finds the camera


def test_estimate_intrinsics_matches_jax():
    h, w = 24, 32
    X, conf = _pointmap(np.random.default_rng(2), h, w, f_true=40.0)
    want = np.asarray(jax_intrinsics(jnp.asarray(X), (h, w), jnp.asarray(conf)))
    got = estimate_intrinsics(_t(X), (h, w), _t(conf))
    assert got.dtype == torch.float32 and got.shape == (3, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


# -- geometry -----------------------------------------------------------------


def test_constrain_points_to_ray_matches_jax():
    rng = np.random.default_rng(3)
    h, w = 6, 8
    K = np.asarray(camera_K(h, w))
    X = rng.normal(size=(2, h * w, 3)).astype(np.float32) + [0, 0, 3]
    want = np.asarray(jax_constrain((h, w), jnp.asarray(X), jnp.asarray(K)))
    got = constrain_points_to_ray((h, w), _t(X), _t(K))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # K is the [3, 3] matrix in both packages; a [4] vector is refused (JAX's
    # decompose_K fails on indexing it)
    with pytest.raises(ValueError, match=r"\[\.\.\., 3, 3\]"):
        backproject(torch.ones(5, 2), torch.ones(5, 1), torch.ones(4))
    assert [float(v) for v in decompose_K(_t(K))] == [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]


# -- the simple matcher ---------------------------------------------------------


def _views(seed, b=2, h=12, w=16):
    rng = np.random.default_rng(seed)
    X11 = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    X21 = X11 + rng.normal(0, 0.08, X11.shape).astype(np.float32)
    D = rng.normal(size=(b, h, w, 8)).astype(np.float32)
    init = rng.integers(0, h * w, (b, h * w)).astype(np.int32)
    payload = rng.normal(size=(b, h, w, 5)).astype(np.float32)
    return X11, X21, D, init, payload


@pytest.mark.parametrize("warm", [False, True])
def test_match_simple_matches_jax(warm):
    X11, X21, _, init, _ = _views(0)
    j_idx, j_valid = jax_match_simple(jnp.asarray(X11), jnp.asarray(X21),
                                      jnp.asarray(init) if warm else None, 0.1)
    t_idx, t_valid = match_simple(_t(X11), _t(X21), _t(init) if warm else None, 0.1)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    assert 0.2 < t_valid.float().mean() < 1.0 or warm  # the gate splits the pixels


@pytest.mark.parametrize("method", ["simple", "auto"])
def test_match_simple_payload_and_hit_match_jax(method):
    """`match` with method simple (and auto -> simple): the payload row gather
    and the scatter-max hit mask, exact."""
    from mast3r_slam_tpu.matching import match as jax_match

    X11, X21, D, init, payload = _views(1)
    with both_configs({"matching": {"method": method, "use_simple": True}}):
        j_out = jax_match(jnp.asarray(X11), jnp.asarray(X21), jnp.asarray(D), jnp.asarray(D),
                          jnp.asarray(init), payload=jnp.asarray(payload), want_hit=True)
        t_out = match(_t(X11), _t(X21), _t(D), _t(D), _t(init), payload=_t(payload),
                      want_hit=True)
    assert len(t_out) == len(j_out) == 4
    for name, a, b in zip(("idx", "valid", "payload_g", "hit"), t_out, j_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert 0 < t_out[3].float().mean() < 1


# -- the calibrated pose GN ------------------------------------------------------


def _pose_problem(seed, h=24, w=32, outliers=0.1):
    """Keyframe measurements [u, v, log z] of a smooth surface and the frame's
    points under a true relative pose, with noise, outliers, points that
    project past the border, points behind the camera and measurements
    below the depth gate."""
    rng = np.random.default_rng(seed)
    K = np.asarray(camera_K(h, w))
    Xk = world_surface(rng, h, w, K)
    xi = np.array([0.03, -0.02, 0.02, 0.02, -0.01, 0.02, 0.03], np.float32)
    T_true = np.asarray(jlie.sim3_exp(jnp.asarray(xi)))
    Xf = np.asarray(jlie.sim3_act(jlie.sim3_inv(T_true), jnp.asarray(Xk)))
    Xf = Xf + rng.normal(0, 1e-3, Xf.shape).astype(np.float32)
    n = h * w
    bad = rng.uniform(size=n) < outliers
    Xf[bad] += rng.normal(0, 0.3, (bad.sum(), 3)).astype(np.float32)
    Xf[rng.uniform(size=n) < 0.03, 2] *= -1.0  # behind the camera
    vv, uu = np.mgrid[0:h, 0:w]
    meas = np.stack([uu.ravel(), vv.ravel(), np.log(Xk[:, 2])], -1).astype(np.float32)
    valid_meas = (Xk[:, 2:3] > 1.7)  # a depth gate that cuts some measurements
    w_ = rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32)
    w_[rng.uniform(size=n) < 0.2] = 0.0
    sqrt_info = np.concatenate([np.repeat(w_, 2, -1), w_ / 10.0], -1).astype(np.float32)
    T_init = np.array([0, 0, 0, 0, 0, 0, 1, 1], np.float32)
    return T_init, Xf.astype(np.float32), meas, sqrt_info, valid_meas, K, (h, w), T_true


def _pose_both(T_init, Xf, meas, sqrt_info, valid_meas, K, img_size, **params):
    args = (T_init, Xf, meas, sqrt_info, valid_meas, K)
    jT, jc = jgn.gauss_newton_pose_calib(*map(jnp.asarray, args), img_size,
                                         params=jgn.GNParams(**params))
    tT, tc = gn.gauss_newton_pose_calib(*map(_t, args), img_size, params=gn.GNParams(**params))
    return np.asarray(jT), np.asarray(jc), tT.numpy(), tc.numpy()


@pytest.mark.parametrize("robust,border,z_eps", [("huber", 0, 0.0), ("tukey", 0, 0.0),
                                                 ("huber", 3, 0.5)])
def test_pose_calib_matches_jax(robust, border, z_eps):
    prob = _pose_problem(0)
    T_true = prob[-1]
    jT, jc, tT, tc = _pose_both(*prob[:-1], robust=robust, pixel_border=border, z_eps=z_eps)
    np.testing.assert_allclose(tT, jT, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tc, jc, rtol=1e-4)
    # the solve moved most of the way to the true pose (scale is weakly
    # observed from one view)
    assert np.abs(tT - T_true)[:7].max() < 0.5 * np.abs(prob[0] - T_true)[:7].max()


def test_pose_calib_early_stop_matches_jax():
    prob = _pose_problem(1, outliers=0.0)
    for max_iter, delta in ((10, 0.05), (3, 1e-3), (1, 1e-3)):
        jT, jc, tT, tc = _pose_both(*prob[:-1], max_iter=max_iter, delta_thresh=delta)
        np.testing.assert_allclose(tT, jT, atol=1e-5, rtol=0)
        np.testing.assert_allclose(tc, jc, rtol=1e-4)


@pytest.mark.parametrize("poison", ["inf_weight", "nan_point"])
def test_pose_calib_non_pd_takes_a_zero_step(poison):
    T_init, Xf, meas, sqrt_info, valid_meas, K, size, _ = _pose_problem(2)
    T_init = np.array([0.01, 0, 0, 0, 0, 0, 1, 1], np.float32)
    # a point that projects inside the image, so that the poison reaches H
    i = (size[0] // 2) * size[1] + size[1] // 2
    valid_meas[i] = True
    if poison == "inf_weight":
        sqrt_info[i] = np.inf
    else:
        Xf[i] = np.nan
    jT, jc, tT, tc = _pose_both(T_init, Xf, meas, sqrt_info, valid_meas, K, size)
    np.testing.assert_array_equal(jT, T_init)
    np.testing.assert_array_equal(tT, T_init)
    assert np.isfinite(jc) == np.isfinite(tc)


# -- the calib and points graph solves -----------------------------------------


@pytest.mark.parametrize("mode,stride", [("calib", 1), ("calib", 2), ("points", 1)])
def test_graph_solve_calib_and_points_match_jax(mode, stride):
    """The calib problem keeps every keyframe's pixels in grid order (pixel n's
    point lies on ray n, as calibrated mode requires); the points problem
    permutes them."""
    rng = np.random.default_rng(4)
    prob = make_graph_problem(rng, num_kf=4, h=8, w=12, num_edges=8, permute=mode != "calib")
    Twc0 = perturb_poses(rng, prob["Twc_gt"], mag=0.02)
    E = prob["ii"].shape[0]
    args = (Twc0, prob["Xs"], prob["Cs"], prob["ii"], prob["jj"], prob["idx"], prob["valid"],
            prob["Q"], np.ones(E, bool), np.arange(4) >= 1)
    K = prob["K"] if mode == "calib" else None
    params = dict(max_iter=10, pixel_border=1)
    jT, _ = jgn.gauss_newton_graph(*map(jnp.asarray, args), mode=mode, K_intr=K,
                                   img_size=prob["img_size"], params=jgn.GNParams(**params),
                                   point_stride=stride)
    tT, _ = gn.gauss_newton_graph(*map(_t, args), mode=mode,
                                  K_intr=None if K is None else _t(K), img_size=prob["img_size"],
                                  params=gn.GNParams(**params), point_stride=stride)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-5, rtol=0)
    gt, T0 = np.asarray(prob["Twc_gt"]), np.asarray(Twc0)
    assert np.abs(tT.numpy() - gt)[1:, :3].max() < np.abs(T0 - gt)[1:, :3].max()


def test_graph_solve_calib_needs_intrinsics():
    prob = make_graph_problem(np.random.default_rng(5), num_kf=3, h=6, w=8, permute=False)
    E = prob["ii"].shape[0]
    args = [_t(a) for a in (prob["Twc_gt"], prob["Xs"], prob["Cs"], prob["ii"], prob["jj"],
                            prob["idx"], prob["valid"], prob["Q"], np.ones(E, bool),
                            np.arange(3) >= 1)]
    with pytest.raises(ValueError, match="K_intr"):
        gn.gauss_newton_graph(*args, mode="calib", img_size=prob["img_size"])


# -- the calibrated tracking core ------------------------------------------------


def _core_inputs(seed, h=32, w=64):
    rng = np.random.default_rng(seed)
    n = h * w
    K = np.asarray(camera_K(h, w))
    Xk = world_surface(rng, h, w, K)
    T_rel = np.asarray(jlie.sim3_exp(jnp.asarray([0.02, -0.01, 0.01, 0.01, 0.02, -0.01, 0.02],
                                                 jnp.float32)))
    Xf = np.asarray(jlie.sim3_act(jlie.sim3_inv(T_rel), jnp.asarray(Xk)))
    Xf = (Xf + rng.normal(0, 1e-3, Xf.shape)).astype(np.float32)
    idx = np.clip(np.arange(n) + rng.integers(-2, 3, n), 0, n - 1).astype(np.int64)
    valid = rng.uniform(size=(n, 1)) < 0.9
    Qff, Qkf = rng.uniform(0.5, 4.0, size=(2, n, 1)).astype(np.float32)
    Cf, Ck = rng.uniform(0.5, 4.0, size=(2, n, 1)).astype(np.float32)
    Xkf = (Xk + rng.normal(0, 1e-2, Xk.shape)).astype(np.float32)
    T_WCk = np.asarray(jlie.sim3_exp(jnp.asarray([0.1, 0, 0, 0, 0.05, 0, 0.0], jnp.float32)))
    # the frame's initial pose a little off the keyframe's: at T_CkCf = I the
    # projections of the ray-constrained points fall exactly on the pixel
    # grid, where the strict border gate (u > border) decides by rounding
    T_WCf = np.asarray(jlie.sim3_mul(jnp.asarray(T_WCk), jlie.sim3_exp(
        jnp.asarray([0.004, -0.003, 0.002, 0.001, -0.002, 0.001, 0.0], jnp.float32))))
    return [idx, valid, Qff, Qkf, Xf, Cf, Xk, Ck, Xkf, T_WCf, T_WCk], K, (h, w)


@pytest.mark.parametrize("robust,border,depth_eps", [("huber", 0, 0.0), ("tukey", 2, 1.8)])
def test_track_core_calib_matches_jax(robust, border, depth_eps):
    args, K, size = _core_inputs(0)
    key = dict(Q_conf=1.5, robust=robust, pixel_border=border, depth_eps=depth_eps)
    jout = jax_core(*map(jnp.asarray, args), jnp.asarray(K), size,
                    jax_cfg_key(JaxTrackingConfig(**key)))
    tout = _track_core_calib(*map(_t, args), _t(K), size, _calib_cfg_key(TrackingConfig(**key)))
    np.testing.assert_array_equal(tout["stats"].numpy(), np.asarray(jout["stats"]))
    assert 0.3 < float(tout["stats"][0]) < 1.0  # the gates select a real subset
    np.testing.assert_allclose(tout["T_CkCf"].numpy(), np.asarray(jout["T_CkCf"]), atol=1e-5)
    np.testing.assert_allclose(tout["T_WCf"].numpy(), np.asarray(jout["T_WCf"]), atol=1e-5)
    np.testing.assert_allclose(tout["Xkk"].numpy(), np.asarray(jout["Xkk"]), atol=1e-4)
    np.testing.assert_allclose(tout["Qk"].numpy(), np.asarray(jout["Qk"]), rtol=1e-6)
    np.testing.assert_allclose(tout["cost"].numpy(), np.asarray(jout["cost"]), rtol=1e-4)
