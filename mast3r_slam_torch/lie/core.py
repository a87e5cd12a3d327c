"""Batched Lie-group operations in PyTorch (the port of
``mast3r_slam_tpu/lie/core.py``).

Layouts are the JAX package's: quaternion ``[qx, qy, qz, qw]`` (Hamilton),
Sim3 element ``[t(3), q(4), s(1)]``, tangent ``[v(3), w(3), sigma(1)]``, and
one retraction convention, left: ``T_new = exp(xi) * T``. Every function
broadcasts over leading batch dimensions. Small-angle branches select with
``torch.where`` over Taylor expansions, as the JAX code does with
``jnp.where``.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
_SMALL = 1e-6


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    # No constant tensor: building one on the card is a host-to-device copy,
    # which synchronizes.
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v + qw*(2 qv×v) + qv×(2 qv×v)."""
    qv, qw = q[..., :3], q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = 2.0 * _cross(qv, v)
    return v + qw * uv + _cross(qv, uv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """so(3) -> unit quaternion, Taylor branch below theta^2 = 1e-6."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    theta = torch.sqrt(theta_sq + _EPS)
    small = theta_sq < _SMALL
    imag = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(0.5 * theta) / theta)
    real = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(0.5 * theta))
    return torch.cat([imag * phi, real], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> so(3) rotation vector (principal log: the qw >= 0
    hemisphere), Taylor branch below |qv|^2 = 1e-6."""
    qv, qw = q[..., :3], q[..., 3:4]
    nv_sq = (qv * qv).sum(-1, keepdim=True)
    nv = torch.sqrt(nv_sq + _EPS)
    sign = torch.where(qw < 0, -1.0, 1.0)
    qv, qw = sign * qv, sign * qw
    theta = 2.0 * torch.atan2(nv, qw)
    qw_c = torch.clamp(qw, min=0.5)
    # theta/|qv| ~ 2/qw (1 - |qv|^2 / (3 qw^2)) for small |qv|
    scale = torch.where(nv_sq < _SMALL, 2.0 / qw_c * (1.0 - nv_sq / (3.0 * qw_c**2)), theta / nv)
    return scale * qv


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] with skew(v) @ x = v × x."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


# ---------------------------------------------------------------------------
# SE(3): element [t(3), q(4)], tangent [v(3), w(3)]
# ---------------------------------------------------------------------------


def _so3_V(omega: torch.Tensor) -> torch.Tensor:
    """Left SO3 Jacobian V(w), with the SE3 exp translation t = V @ v."""
    theta_sq = (omega * omega).sum(-1)[..., None, None]
    theta = torch.sqrt(theta_sq + _EPS)
    small = theta_sq < _SMALL
    K = skew(omega)
    A = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / theta_sq)
    B = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta_sq * theta))
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    return eye + A * K + B * (K @ K)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) [..., 6] -> SE3 [..., 7]."""
    v, omega = xi[..., :3], xi[..., 3:6]
    t = (_so3_V(omega) @ v[..., None])[..., 0]
    return torch.cat([t, so3_exp(omega)], dim=-1)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE3 [..., 7] -> se(3) [..., 6]."""
    t, q = T[..., :3], T[..., 3:7]
    omega = so3_log(q)
    v = torch.linalg.solve(_so3_V(omega), t[..., None])[..., 0]
    return torch.cat([v, omega], dim=-1)


# ---------------------------------------------------------------------------
# Sim(3): element [t(3), q(4), s(1)], tangent [v(3), w(3), sigma(1)]
# ---------------------------------------------------------------------------


def sim3_identity(batch_shape: tuple[int, ...] = (), dtype=torch.float32, device=None):
    # filled on the device: a tensor built from a host list would be a
    # host-to-device copy, which waits for the device (one per Frame)
    e = torch.zeros(*batch_shape, 8, dtype=dtype, device=device)
    e[..., 6:] = 1.0
    return e


_W_DOUBLINGS = 6  # handles ||sigma*I + [w]x|| up to ~16 (theta <= pi always)


def _sim3_W(omega: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Sim3 W matrix (exp translation t = W @ v), W = ∫_0^1 e^{uM} du with
    M = sigma*I + [w]x, by scaling and doubling: a degree-5 series at
    M / 2^6, then six doublings W(2m) = 0.5 (I + e^m) W(m) with e^m in
    closed form. Uniformly accurate in f32, unlike the closed-form
    coefficients that cancel near their small-angle branch points."""
    K = skew(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    scale = 0.5**_W_DOUBLINGS
    M = sigma[..., None, None] * eye * scale + K * scale
    W = eye + M / 6.0
    W = eye + (M @ W) / 5.0
    W = eye + (M @ W) / 4.0
    W = eye + (M @ W) / 3.0
    W = eye + (M @ W) / 2.0
    for i in range(_W_DOUBLINGS):
        exp_scale = 0.5 ** (_W_DOUBLINGS - i)
        R = quat_to_matrix(so3_exp(omega * exp_scale))
        E = torch.exp(sigma * exp_scale)[..., None, None] * R
        W = 0.5 * ((eye + E) @ W)
    return W


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """sim(3) [..., 7] -> Sim3 [..., 8]."""
    v, omega, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    q = so3_exp(omega)
    s = torch.exp(sigma)
    t = (_sim3_W(omega, sigma) @ v[..., None])[..., 0]
    return torch.cat([t, q, s[..., None]], dim=-1)


def sim3_log(T: torch.Tensor) -> torch.Tensor:
    """Sim3 [..., 8] -> sim(3) [..., 7], the inverse of `sim3_exp`."""
    t, q, s = T[..., :3], T[..., 3:7], T[..., 7]
    omega = so3_log(q)
    sigma = torch.log(s)
    v = torch.linalg.solve(_sim3_W(omega, sigma), t[..., None])[..., 0]
    return torch.cat([v, omega, sigma[..., None]], dim=-1)


def sim3_inv(T: torch.Tensor) -> torch.Tensor:
    """(t, R, s) -> (-s^-1 R^T t, R^T, s^-1)."""
    t, q, s = T[..., :3], T[..., 3:7], T[..., 7:8]
    q_inv = quat_conj(q)
    s_inv = 1.0 / s
    return torch.cat([-s_inv * quat_rotate(q_inv, t), q_inv, s_inv], dim=-1)


def sim3_mul(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """Ta * Tb, acting as p -> Ta(Tb(p))."""
    ta, qa, sa = Ta[..., :3], Ta[..., 3:7], Ta[..., 7:8]
    tb, qb, sb = Tb[..., :3], Tb[..., 3:7], Tb[..., 7:8]
    t = sa * quat_rotate(qa, tb) + ta
    return torch.cat([t, quat_mul(qa, qb), sa * sb], dim=-1)


def sim3_act(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """s * R @ p + t; T broadcasts against points p [..., 3]."""
    t, q, s = T[..., :3], T[..., 3:7], T[..., 7:8]
    return s * quat_rotate(q, p) + t


def sim3_relative(Ti: torch.Tensor, Tj: torch.Tensor) -> torch.Tensor:
    """T_ij = Ti^-1 * Tj (maps j-frame points into i's frame)."""
    return sim3_mul(sim3_inv(Ti), Tj)


def sim3_retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left retraction exp(xi) * T."""
    return sim3_mul(sim3_exp(xi), T)


def point_jacobian(p: torch.Tensor) -> torch.Tensor:
    """d(exp(xi) . p)/dxi at xi = 0 for the left perturbation, [..., 3, 7]:
    exp(xi) . p ~ p + v + w x p + sigma p, so J = [ I | -[p]x | p ]."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(*p.shape[:-1], 3, 3)
    return torch.cat([eye, -skew(p), p[..., None]], dim=-1)


def sim3_matrix(T: torch.Tensor) -> torch.Tensor:
    """Homogeneous 4x4 [..., 4, 4] with s*R upper-left block."""
    t, q, s = T[..., :3], T[..., 3:7], T[..., 7:8]
    top = torch.cat([s[..., None] * quat_to_matrix(q), t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def sim3_adjoint(T: torch.Tensor) -> torch.Tensor:
    """Adjoint matrix Ad_T [..., 7, 7]: T exp(xi) T^-1 = exp(Ad_T xi). With the
    tangent order (v, w, sigma):
        Ad_T = [[ s R,  [t]x R,  -t ],
                [  0,      R,     0 ],
                [  0,      0,     1 ]]"""
    t, q, s = T[..., :3], T[..., 3:7], T[..., 7:8]
    R = quat_to_matrix(q)
    top = torch.cat([s[..., None] * R, skew(t) @ R, -t[..., None]], dim=-1)
    zeros = torch.zeros_like(top[..., :3])
    mid = torch.cat([zeros, R, zeros[..., :1]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 6] = 1.0
    return torch.cat([top, mid, bottom], dim=-2)
