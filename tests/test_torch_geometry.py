"""Port Lie groups (lie/core.py), geometry, pointmap fusion and the Cholesky
solve vs the JAX package on the same numpy-seeded inputs.

f32 throughout; atol 1e-6 on unit-scale quantities (a few f32 ulps of
transcendental and sum-order noise), scaled by magnitude where stated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import frame as jframe
from mast3r_slam_tpu import geometry as jgeo
from mast3r_slam_tpu.lie import core as jlie
from mast3r_slam_tpu.ops.linalg import cholesky_solve as jax_cholesky_solve
from mast3r_slam_torch import frame, geometry
from mast3r_slam_torch.lie import core as lie
from mast3r_slam_torch.ops.linalg import cholesky_solve

ATOL = 1e-6


def _sim3(rng, n, angle=1.0, trans=1.0):
    xi = rng.normal(size=(n, 7)).astype(np.float32)
    xi[:, :3] *= trans
    xi[:, 3:6] *= angle
    xi[:, 6] *= 0.3
    return np.array(jlie.sim3_exp(jnp.asarray(xi)))


def _close(ours, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.mark.parametrize("angle", [1e-5, 1e-2, 1.0, 3.0])
def test_sim3_exp_matches_jax_in_every_regime(angle):
    """Small-angle Taylor branch, the doubling scheme, and large angles."""
    rng = np.random.default_rng(0)
    xi = rng.normal(size=(64, 7)).astype(np.float32)
    xi[:, 3:6] *= angle / np.linalg.norm(xi[:, 3:6], axis=-1, keepdims=True)
    xi[:, 6] *= 0.5
    _close(lie.sim3_exp(torch.from_numpy(xi)), jlie.sim3_exp(jnp.asarray(xi)), atol=2e-6)
    _close(lie.so3_exp(torch.from_numpy(xi[:, 3:6])), jlie.so3_exp(jnp.asarray(xi[:, 3:6])))


def test_sim3_group_ops_match_jax():
    rng = np.random.default_rng(1)
    Ta, Tb = _sim3(rng, 32), _sim3(rng, 32)
    p = rng.normal(size=(32, 3)).astype(np.float32)
    xi = (0.1 * rng.normal(size=(32, 7))).astype(np.float32)
    ta, tb, tp, txi = map(torch.from_numpy, (Ta, Tb, p, xi))
    _close(lie.sim3_mul(ta, tb), jlie.sim3_mul(Ta, Tb), atol=1e-5)
    _close(lie.sim3_inv(ta), jlie.sim3_inv(Ta), atol=1e-5, rtol=1e-6)
    _close(lie.sim3_act(ta, tp), jlie.sim3_act(Ta, p), atol=1e-5)
    _close(lie.sim3_retract(ta, txi), jlie.sim3_retract(Ta, xi), atol=1e-5)
    _close(lie.quat_mul(ta[:, 3:7], tb[:, 3:7]), jlie.quat_mul(Ta[:, 3:7], Tb[:, 3:7]))
    _close(lie.quat_to_matrix(ta[:, 3:7]), jlie.quat_to_matrix(Ta[:, 3:7]))
    _close(lie.skew(tp), jlie.skew(p))
    # broadcasting of one pose over many points, as the tracker uses it
    _close(lie.sim3_act(ta[:1], tp), jlie.sim3_act(Ta[:1], p), atol=1e-5)
    _close(lie.sim3_identity(), jlie.sim3_identity())


def test_sim3_W_matches_jax():
    rng = np.random.default_rng(2)
    omega = rng.normal(size=(16, 3)).astype(np.float32)
    sigma = rng.normal(size=(16,)).astype(np.float32)
    _close(lie._sim3_W(torch.from_numpy(omega), torch.from_numpy(sigma)),
           jlie._sim3_W(jnp.asarray(omega), jnp.asarray(sigma)), atol=2e-6)


def test_ray_geometry_matches_jax():
    rng = np.random.default_rng(3)
    X = (rng.normal(size=(128, 3)) * np.array([1, 1, 3])).astype(np.float32)
    X[0] = 0.0  # the epsilon of point_to_dist keeps the origin finite
    tX = torch.from_numpy(X)
    _close(geometry.point_to_dist(tX), jgeo.point_to_dist(X), atol=1e-6, rtol=1e-6)
    _close(geometry.normalize_rays(tX), jgeo.normalize_rays(X))
    _close(geometry.point_to_ray_dist(tX), jgeo.point_to_ray_dist(X), atol=1e-6, rtol=1e-6)
    S = geometry.cartesian_to_spherical(tX)
    _close(S, jgeo.cartesian_to_spherical(X), atol=2e-6, rtol=1e-6)
    _close(geometry.spherical_to_cartesian(S), jgeo.spherical_to_cartesian(np.asarray(S)),
           atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize("mode", ["recent", "indep_conf", "weighted_pointmap",
                                  "weighted_spherical"])
def test_fuse_pointmap_matches_jax(mode):
    rng = np.random.default_rng(4)
    X_old, X_new = (rng.normal(size=(2, 256, 3)) + [0, 0, 3]).astype(np.float32)
    C_old, C_new = rng.uniform(1, 5, size=(2, 256, 1)).astype(np.float32)
    args = (X_old, C_old, X_new, C_new)
    for ours, ref in zip(frame.fuse_pointmap(*map(torch.from_numpy, args), mode),
                         jframe.fuse_pointmap(*args, mode=mode)):
        _close(ours, ref, atol=5e-6, rtol=1e-6)
    for n_old in (0.0, 1.0, 3.0):
        n = np.float32(n_old)
        ours = frame.fuse_pointmap_masked(torch.from_numpy(X_old), torch.from_numpy(C_old),
                                          torch.tensor(n), torch.from_numpy(X_new),
                                          torch.from_numpy(C_new), mode)
        ref = jframe.fuse_pointmap_masked(X_old, C_old, n, X_new, C_new, mode=mode)
        for a, b in zip(ours, ref):
            _close(a, b, atol=5e-6, rtol=1e-6)


def test_cholesky_solve_matches_jax_and_flags_non_pd():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(4, 7, 7)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(7, dtype=np.float32)
    g = rng.normal(size=(4, 7)).astype(np.float32)
    _close(cholesky_solve(torch.from_numpy(H), torch.from_numpy(g)),
           jax_cholesky_solve(jnp.asarray(H), jnp.asarray(g)), atol=1e-4, rtol=1e-4)
    H[1] = -np.eye(7, dtype=np.float32)  # not positive definite
    x = cholesky_solve(torch.from_numpy(H), torch.from_numpy(g))
    assert torch.isnan(x[1]).all() and torch.isfinite(x[[0, 2, 3]]).all()
    assert np.isnan(np.asarray(jax_cholesky_solve(jnp.asarray(H), jnp.asarray(g)))[1]).all()
