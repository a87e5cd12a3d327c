"""The rest of the port's Lie groups and geometry against the JAX package:
`quat_normalize`, `so3_log`, `se3_exp`, `se3_log`, `sim3_log`,
`sim3_relative`, `point_jacobian`, the `SO3` / `SE3` / `Sim3` classes, and
`point_to_ray_dist`, `act_Sim3` and `project_calib` with their analytic
Jacobians, on the same numpy-seeded f32 inputs.

Bands: 1e-6 on unit-scale values (as tests/test_torch_geometry.py), 1e-5 on
the log maps (an arctangent and a 3x3 solve in f32 on each side), 1e-4
absolute and 1e-6 relative on the pixel-scale projections. Each
analytic Jacobian is also held to `torch.func.jacfwd` of the port's own
function within 1e-5 (tests/test_lie.py and tests/test_geometry.py hold
JAX's to `jax.jacfwd`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import geometry as jgeo
from mast3r_slam_tpu import lie as jlie_pkg
from mast3r_slam_tpu.lie import core as jlie
from mast3r_slam_torch import geometry, lie
from mast3r_slam_torch.lie import core

ATOL = 1e-6
LOG_ATOL = 1e-5
JAC_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def _tangents(rng, n, dim, mag=0.5, small=False):
    xi = rng.normal(size=(n, dim)).astype(np.float32) * mag
    if small:
        xi[: n // 2] *= 1e-4  # the Taylor branches
    return xi


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[: n // 4, 3] *= -1.0  # both hemispheres
    return q


def test_quat_normalize_and_so3_log_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(32, 4)).astype(np.float32) * 3.0
    _close(core.quat_normalize(_t(q)), jlie.quat_normalize(jnp.asarray(q)))
    qs = np.concatenate([_quats(rng, 32),
                         np.asarray(jlie.so3_exp(jnp.asarray(_tangents(rng, 16, 3, small=True))))])
    _close(core.so3_log(_t(qs)), jlie.so3_log(jnp.asarray(qs)), LOG_ATOL)


@pytest.mark.parametrize("group", ["se3", "sim3"])
def test_exp_log_match_jax(group):
    rng = np.random.default_rng(1)
    dim = 6 if group == "se3" else 7
    xi = _tangents(rng, 32, dim, small=True)
    if group == "sim3":
        xi[:, 6] *= 0.5
    exp, log = getattr(core, f"{group}_exp"), getattr(core, f"{group}_log")
    jexp, jlog = getattr(jlie, f"{group}_exp"), getattr(jlie, f"{group}_log")
    T = exp(_t(xi))
    _close(T, jexp(jnp.asarray(xi)))
    _close(log(T), jlog(jnp.asarray(T.numpy())), LOG_ATOL)
    _close(log(T), xi, LOG_ATOL)  # the round trip


def test_sim3_relative_and_point_jacobian_match_jax():
    rng = np.random.default_rng(2)
    Ti = np.asarray(jlie.sim3_exp(jnp.asarray(_tangents(rng, 16, 7))))
    Tj = np.asarray(jlie.sim3_exp(jnp.asarray(_tangents(rng, 16, 7))))
    _close(core.sim3_relative(_t(Ti), _t(Tj)), jlie.sim3_relative(jnp.asarray(Ti), jnp.asarray(Tj)))
    p = rng.normal(size=(5, 16, 3)).astype(np.float32)
    _close(core.point_jacobian(_t(p)), jlie.point_jacobian(jnp.asarray(p)))
    # d(exp(xi) . p)/dxi at 0, by jacfwd of the port's own exp
    # (a batch of one: under jacfwd a 0-d dual tensor times a Python float
    # comes back float64 in torch 2.13)
    J = torch.func.jacfwd(
        lambda x: core.sim3_act(core.sim3_exp(x), _t(p[0, :1])))(torch.zeros(1, 7))
    _close(J[0, :, 0], core.point_jacobian(_t(p[0, 0])).numpy(), JAC_ATOL)


@pytest.mark.parametrize("name", ["SO3", "SE3", "Sim3"])
def test_group_classes_match_jax(name):
    rng = np.random.default_rng(3)
    dim = {"SO3": 3, "SE3": 6, "Sim3": 7}[name]
    cls, jcls = getattr(lie, name), getattr(jlie_pkg, name)
    xa, xb, xr = (_tangents(rng, 8, dim) for _ in range(3))
    p = rng.normal(size=(8, 3)).astype(np.float32)
    a, b = cls.exp(_t(xa)), cls.exp(_t(xb))
    ja, jb = jcls.exp(jnp.asarray(xa)), jcls.exp(jnp.asarray(xb))
    _close(a.data, ja.data)
    _close((a * b).data, (ja * jb).data)
    _close(a.inv().data, ja.inv().data)
    _close(a.act(_t(p)), ja.act(jnp.asarray(p)))
    _close(a.matrix(), ja.matrix())
    _close(a.retr(_t(xr)).data, ja.retr(jnp.asarray(xr)).data)
    _close(a.log(), ja.log(), LOG_ATOL)
    _close(cls.identity((2,)).data, jcls.identity((2,)).data)
    if name != "SO3":
        _close(a.translation, ja.translation)
        _close(a.rotation.data, ja.rotation.data)
    if name == "Sim3":
        _close(a.scale, ja.scale)
        _close(a.adjoint(), ja.adjoint())


def test_point_to_ray_dist_jacobian():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(4, 8, 3)).astype(np.float32) + np.float32([0, 0, 2])
    rd, J = geometry.point_to_ray_dist(_t(X), jacobian=True)
    jrd, jJ = jgeo.point_to_ray_dist(jnp.asarray(X), jacobian=True)
    _close(rd, jrd)
    _close(J, jJ)
    assert torch.equal(rd, geometry.point_to_ray_dist(_t(X)))
    Jad = torch.func.jacfwd(geometry.point_to_ray_dist)(_t(X[0, 0]))
    _close(J[0, 0], Jad.numpy(), JAC_ATOL)


def test_act_sim3_jacobian():
    rng = np.random.default_rng(5)
    T = np.asarray(jlie.sim3_exp(jnp.asarray(_tangents(rng, 4, 7))))[:, None]
    p = rng.normal(size=(4, 8, 3)).astype(np.float32)
    pW, J = geometry.act_Sim3(_t(T), _t(p), jacobian=True)
    jpW, jJ = jgeo.act_Sim3(jnp.asarray(T), jnp.asarray(p), jacobian=True)
    _close(pW, jpW)
    _close(J, jJ)
    _close(geometry.act_Sim3(_t(T), _t(p)), jpW)
    # the left-perturbation Jacobian: d(exp(xi) T p)/dxi at xi = 0
    Jad = torch.func.jacfwd(
        lambda xi: core.sim3_act(core.sim3_retract(_t(T[1]), xi), _t(p[1, 2:3])))(torch.zeros(1, 7))
    _close(J[1, 2], Jad[0, :, 0].numpy(), JAC_ATOL)


@pytest.mark.parametrize("border,z_eps", [(0, 0.0), (2, 0.1)])
def test_project_calib_jacobian(border, z_eps):
    rng = np.random.default_rng(6)
    h, w = 24, 32
    K = np.float32([[20.0, 0, 15.5], [0, 21.0, 11.5], [0, 0, 1]])
    P = rng.normal(size=(6, 10, 3)).astype(np.float32) * np.float32([1, 1, 0.5])
    P[..., 2] += 1.5
    P[0, :3, 2] = [-0.5, 0.05, 0.0]  # behind, near and on the camera plane
    pz, J, valid = geometry.project_calib(_t(P), _t(K), (h, w), jacobian=True, border=border,
                                          z_eps=z_eps)
    jpz, jJ, jvalid = jgeo.project_calib(jnp.asarray(P), jnp.asarray(K), (h, w), jacobian=True,
                                         border=border, z_eps=z_eps)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.any() and not valid.all()
    np.testing.assert_allclose(pz.numpy(), np.asarray(jpz), atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), atol=1e-4, rtol=1e-6)
    pz2, valid2 = geometry.project_calib(_t(P), _t(K), (h, w), border=border, z_eps=z_eps)
    assert torch.equal(pz2, pz) and torch.equal(valid2, valid)
    i, j = 2, 3  # a point in front of the camera: d[u, v, log z]/dP
    Jad = torch.func.jacfwd(
        lambda x: geometry.project_calib(x, _t(K), (h, w))[0])(_t(P[i, j]))
    _close(J[i, j], Jad.numpy(), JAC_ATOL)
