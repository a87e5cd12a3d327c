"""Port pose Gauss-Newton (ops/gauss_newton.py) vs the JAX solver.

The same numpy-seeded problem goes to both: keyframe points Xk, a true
relative Sim(3) pose, frame points Xf = T^-1 Xk plus noise, per-point
whitening with some points switched off, and outliers. Both run 10
f32 iterations from the identity; bands: pose atol 1e-5 (f32 sum-order noise
in the 7x7 normal equations over N points, through <= 10 retractions), cost
rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.lie import core as jlie
from mast3r_slam_tpu.ops import gauss_newton as jgn
from mast3r_slam_torch.ops import gauss_newton as gn


def _problem(seed, n=600, outliers=0.1):
    rng = np.random.default_rng(seed)
    Xk = (rng.normal(size=(n, 3)) * [1.0, 0.7, 0.5] + [0, 0, 3]).astype(np.float32)
    xi = np.array([0.05, -0.03, 0.02, 0.02, -0.01, 0.03, 0.05], np.float32)
    T_true = np.asarray(jlie.sim3_exp(jnp.asarray(xi)))
    Xf = np.asarray(jlie.sim3_act(jlie.sim3_inv(T_true), jnp.asarray(Xk)))
    Xf = Xf + rng.normal(0, 1e-3, Xf.shape).astype(np.float32)
    bad = rng.uniform(size=n) < outliers
    Xf[bad] += rng.normal(0, 0.5, (bad.sum(), 3)).astype(np.float32)
    rd_k = np.concatenate([Xk / np.linalg.norm(Xk, axis=-1, keepdims=True),
                           np.linalg.norm(Xk, axis=-1, keepdims=True)], -1).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=(n, 1)).astype(np.float32)
    w[rng.uniform(size=n) < 0.2] = 0.0
    sqrt_info = np.concatenate([np.repeat(w / 0.003, 3, -1), w / 10.0], -1).astype(np.float32)
    T_init = np.array([0, 0, 0, 0, 0, 0, 1, 1], np.float32)
    return T_init, np.array(Xf, np.float32), rd_k, sqrt_info, T_true


def _solve_both(T_init, Xf, rd_k, sqrt_info, **params):
    jT, jcost = jgn.gauss_newton_pose_rays(
        *map(jnp.asarray, (T_init, Xf, rd_k, sqrt_info)), params=jgn.GNParams(**params))
    tT, tcost = gn.gauss_newton_pose_rays(
        *map(torch.from_numpy, (T_init, Xf, rd_k, sqrt_info)), params=gn.GNParams(**params))
    return np.asarray(jT), np.asarray(jcost), tT.numpy(), tcost.numpy()


@pytest.mark.parametrize("robust", ["huber", "tukey"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pose_solve_matches_jax(seed, robust):
    T_init, Xf, rd_k, sqrt_info, T_true = _problem(seed)
    jT, jcost, tT, tcost = _solve_both(T_init, Xf, rd_k, sqrt_info, robust=robust)
    np.testing.assert_allclose(tT, jT, atol=1e-5)
    np.testing.assert_allclose(tcost, jcost, rtol=1e-4)
    # the problem is well posed: the solve lands near the true pose (the
    # scale is the loosest: distances carry 1/sigma_dist = 0.1 weight)
    np.testing.assert_allclose(tT, T_true, atol=1e-2)


def test_early_stop_freezes_the_pose_like_the_while_loop():
    """A loose delta threshold stops JAX's while_loop after a few steps; the
    port's fixed-count loop must freeze at the same iterate."""
    T_init, Xf, rd_k, sqrt_info, _ = _problem(2, outliers=0.0)
    for max_iter, delta in ((10, 0.05), (3, 1e-3), (1, 1e-3)):
        jT, jcost, tT, tcost = _solve_both(T_init, Xf, rd_k, sqrt_info,
                                           max_iter=max_iter, delta_thresh=delta)
        np.testing.assert_allclose(tT, jT, atol=1e-5)
        np.testing.assert_allclose(tcost, jcost, rtol=1e-4)


@pytest.mark.parametrize("poison", ["inf_weight", "nan_point"])
def test_non_pd_guard_zeroes_the_step(poison):
    """A system whose Cholesky fails (non-finite H) takes a zero step in both:
    the pose stays at its start."""
    T_init, Xf, rd_k, sqrt_info, _ = _problem(3)
    T_init = np.array([0.01, 0, 0, 0, 0, 0, 1, 1], np.float32)
    if poison == "inf_weight":
        sqrt_info[5] = np.inf
    else:
        Xf[7] = np.nan
    jT, jcost, tT, tcost = _solve_both(T_init, Xf, rd_k, sqrt_info)
    np.testing.assert_array_equal(jT, T_init)
    np.testing.assert_array_equal(tT, T_init)
    assert np.isfinite(jcost) == np.isfinite(tcost)


def test_robust_weights_match_jax():
    r = np.linspace(-8, 8, 401).astype(np.float32)
    np.testing.assert_allclose(gn.huber_weight(torch.from_numpy(r)).numpy(),
                               np.asarray(jgn.huber_weight(jnp.asarray(r))), atol=1e-7)
    np.testing.assert_allclose(gn.tukey_weight(torch.from_numpy(r)).numpy(),
                               np.asarray(jgn.tukey_weight(jnp.asarray(r))), atol=1e-7)
    with pytest.raises(ValueError):
        gn.robust_weight(torch.from_numpy(r), gn.GNParams(robust="cauchy"))
