"""Frontend pose Gauss-Newton, ray-distance objective (the port of
``gauss_newton_pose_rays`` / ``_pose_gn_loop_rays_soa`` in
``mast3r_slam_tpu/ops/gauss_newton.py``).

Residual r_n = rd_k[n] - rd(T . Xf[n]) in R^4 (unit ray + distance),
whitened per point, IRLS-reweighted (Huber or Tukey), with the chain rule
folded analytically in structure-of-arrays layout ([*, N]): the normal
equations are one [7, 4N] x [4N, 7] product, left to `torch.matmul` as the
JAX package leaves it to XLA.

Loop design. JAX runs a ``lax.while_loop`` that stops when the relative cost
change is below ``rel_error`` or the step norm below ``delta_thresh``. Here
the loop always runs ``max_iter`` iterations and a device-side `done` flag
freezes the pose (and the convergence state) once the JAX condition would
have stopped; the result is the same and the host never reads a value
inside the loop. As in JAX, ``rel_error`` is the loop's own 1e-3: the
tracker's ``tracking.rel_error`` does not reach it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mast3r_slam_torch.lie import core as lie
from mast3r_slam_torch.ops.linalg import cholesky_solve


class GNParams(NamedTuple):
    """Solver knobs (defaults = the reference local_opt config)."""

    sigma_ray: float = 0.003
    sigma_dist: float = 10.0
    sigma_pixel: float = 1.0
    sigma_depth: float = 10.0
    C_thresh: float = 0.0
    Q_thresh: float = 1.5
    huber_k: float = 1.345
    robust: str = "huber"  # huber | tukey
    tukey_t: float = 4.6851
    max_iter: int = 10
    delta_thresh: float = 1e-3
    pixel_border: int = 0
    z_eps: float = 0.0
    reg: float = 1e-6


def huber_weight(r: torch.Tensor, k: float = 1.345) -> torch.Tensor:
    """IRLS Huber weight: 1 inside the k-tube, k/|r| outside."""
    r_abs = r.abs()
    return torch.where(r_abs < k, 1.0, k / torch.clamp(r_abs, min=1e-12))


def tukey_weight(r: torch.Tensor, t: float = 4.6851) -> torch.Tensor:
    """IRLS Tukey biweight: (1-(r/t)^2)^2 inside the t-tube, 0 outside."""
    tmp = 1.0 - (r / t) ** 2
    return torch.where(r.abs() < t, tmp * tmp, 0.0)


def robust_weight(r: torch.Tensor, p: GNParams) -> torch.Tensor:
    if p.robust == "huber":
        return huber_weight(r, p.huber_k)
    if p.robust == "tukey":
        return tukey_weight(r, p.tukey_t)
    raise ValueError(f"unknown robust kind {p.robust!r}")


def gauss_newton_pose_rays(
    T_init: torch.Tensor,  # [8] initial T_CkCf
    Xf: torch.Tensor,  # [N, 3] frame points (gathered to keyframe order)
    rd_k: torch.Tensor,  # [N, 4] keyframe ray-distance measurements
    sqrt_info: torch.Tensor,  # [N, 4] whitening (validity and confidence folded in)
    params: GNParams = GNParams(),
):
    """-> (T [8], final cost []): the tracker's ray-distance pose solve."""
    return _pose_gn_loop_rays_soa(T_init, Xf.T, rd_k.T, sqrt_info.T, params)


def _cross_soa(a, b):
    """Cross product of [3, N] component stacks."""
    a0, a1, a2 = a[0], a[1], a[2]
    b0, b1, b2 = b[0], b[1], b[2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0])


def _pose_gn_loop_rays_soa(T_init, Xt, rdk_t, w_t, p: GNParams, rel_error: float = 1e-3):
    """Xt [3, N], rdk_t / w_t [4, N]. With P = d*r the chained Jacobian is
        drd/dX @ [I | -[P]x | P] = [ d^-1(I - r r^T) | -[r]x | 0 ]
                                   [       r^T       |   0   | d ]
    so no per-point matrix products are formed."""

    def solve_step(T):
        t, q, s = T[:3], T[3:7], T[7]
        qv, qw = q[:3, None].expand_as(Xt), q[3]
        uv = 2.0 * _cross_soa(qv, Xt)
        P = s * (Xt + qw * uv + _cross_soa(qv, uv)) + t[:, None]  # [3, N]
        d = torch.sqrt((P * P).sum(0) + 1e-10)
        dinv = 1.0 / d
        r0, r1, r2 = P[0] * dinv, P[1] * dinv, P[2] * dinv
        res = torch.stack([rdk_t[0] - r0, rdk_t[1] - r1, rdk_t[2] - r2, rdk_t[3] - d])
        robust = w_t * torch.sqrt(robust_weight(w_t * res, p))
        z = torch.zeros_like(d)
        jrow = [
            [dinv * (1.0 - r0 * r0), -dinv * r0 * r1, -dinv * r0 * r2, z, r2, -r1, z],
            [-dinv * r1 * r0, dinv * (1.0 - r1 * r1), -dinv * r1 * r2, -r2, z, r0, z],
            [-dinv * r2 * r0, -dinv * r2 * r1, dinv * (1.0 - r2 * r2), r1, -r0, z, z],
            [r0, r1, r2, z, z, z, d],
        ]
        Bm = torch.stack(
            [torch.cat([-robust[r] * jrow[r][a] for r in range(4)]) for a in range(7)]
        )  # [7, 4N]
        b = (robust * res).reshape(-1)
        H = Bm @ Bm.T
        g = Bm @ b
        cost = 0.5 * (b * b).sum()
        tau = cholesky_solve(H, -g, reg=p.reg)
        tau = torch.where(torch.isfinite(tau).all(), tau, torch.zeros_like(tau))
        return lie.sim3_retract(T, tau), tau, cost

    inf = torch.full((), torch.inf, dtype=T_init.dtype, device=T_init.device)
    T, old_cost, new_cost, delta_norm = T_init, inf, inf, inf
    done = torch.zeros((), dtype=torch.bool, device=T_init.device)
    for it in range(p.max_iter):
        if it > 0:
            converged = ((old_cost - new_cost).abs() / (old_cost + 1e-10) < rel_error) | (
                delta_norm < p.delta_thresh
            )
            done = done | converged
        T_new, tau, cost = solve_step(T)
        T = torch.where(done, T, T_new)
        old_cost = torch.where(done, old_cost, new_cost)
        new_cost = torch.where(done, new_cost, cost)
        delta_norm = torch.where(done, delta_norm, torch.linalg.vector_norm(tau))
    return T, new_cost
