"""Gauss-Newton solvers: the frontend pose solves (ray-distance and
calibrated objectives) and the backend factor-graph solve over the keyframe
arena (rays, points and calib modes). The port of
``gauss_newton_pose_rays`` / ``_pose_gn_loop_rays_soa``,
``gauss_newton_pose_calib`` and ``gauss_newton_graph`` (with
``_stride_indices``, ``_edge_system``, ``_resolve_edge_chunk``,
``_edge_blocks``, ``_assemble_Hg``) in ``mast3r_slam_tpu/ops/gauss_newton.py``.

Frontend.

Residual r_n = rd_k[n] - rd(T . Xf[n]) in R^4 (unit ray + distance), or
[u, v, log z] of the keyframe pixel minus the projection of T . Xf[n] in
calibrated mode, whitened per point, IRLS-reweighted (Huber or Tukey), with
the chain rule folded analytically in structure-of-arrays layout ([*, N]):
the normal equations are one [7, RN] x [RN, 7] product, left to
`torch.matmul` as the JAX package leaves it to XLA. On the card the
ray-distance solve is instead one hand-written kernel launch an iteration
(``ops/pose_gn.py``, ``csrc/pose_gn.cu``): its plain loop issued ~650 PyTorch
kernels an iteration and was bound by their launches. `_pose_gn_loop_rays_soa`
stays its plain version, which CPU tensors take.

Loop design. JAX runs a ``lax.while_loop`` that stops when the relative cost
change is below ``rel_error`` or the step norm below ``delta_thresh``. Here
the loop always runs ``max_iter`` iterations and a device-side `done` flag
freezes the pose (and the convergence state) once the JAX condition would
have stopped; the result is the same and the host never reads a value
inside the loop. As in JAX, ``rel_error`` is the loop's own 1e-3: the
tracker's ``tracking.rel_error`` does not reach it.

Batched streams. The rays pose solve takes an optional leading batch
dimension [B] (the serving path tracks B streams in one solve, where JAX
vmaps the solve): the finiteness guard, the `done` flag and the convergence
state are per stream, so each stream freezes at the iteration where JAX's
vmapped ``while_loop`` would stop it, and a stream whose system is not
positive definite takes a zero step without touching the others. The
launches of one solve do not depend on B.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mast3r_slam_torch.lie import core as lie
from mast3r_slam_torch.ops import pose_gn
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
    T_init: torch.Tensor,  # [..., 8] initial T_CkCf
    Xf: torch.Tensor,  # [..., N, 3] frame points (gathered to keyframe order)
    rd_k: torch.Tensor,  # [..., N, 4] keyframe ray-distance measurements
    sqrt_info: torch.Tensor,  # [..., N, 4] whitening (validity and confidence folded in)
    params: GNParams = GNParams(),
):
    """-> (T [..., 8], final cost [...]): the tracker's ray-distance pose
    solve, over optional leading batch dimensions (one stream each). CUDA
    tensors go to the kernel (`pose_gn.pose_gn_rays`, which takes float32
    only), CPU tensors to the plain loop."""
    if Xf.is_cuda:
        T, cost, _ = pose_gn.pose_gn_rays(T_init, Xf, rd_k, sqrt_info, params)
    else:
        T, cost, _ = _pose_gn_loop_rays_soa(T_init, Xf.mT, rd_k.mT, sqrt_info.mT, params)
    return T, cost


def _cross_soa(a, b):
    """Cross product of [..., 3, N] component stacks."""
    a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-2)


def _pose_gn_loop_rays_soa(T_init, Xt, rdk_t, w_t, p: GNParams,
                           rel_error: float = pose_gn.REL_ERROR, count: bool = False):
    """Xt [..., 3, N], rdk_t / w_t [..., 4, N] -> (T, final cost,
    iterations or None: `_pose_gn_iterate`'s). With P = d*r the chained
    Jacobian is
        drd/dX @ [I | -[P]x | P] = [ d^-1(I - r r^T) | -[r]x | 0 ]
                                   [       r^T       |   0   | d ]
    so no per-point matrix products are formed."""

    def solve_step(T):
        t, q, s = T[..., :3, None], T[..., 3:7, None], T[..., 7:, None]
        qv, qw = q[..., :3, :].expand_as(Xt), q[..., 3:, :]
        uv = 2.0 * _cross_soa(qv, Xt)
        P = s * (Xt + qw * uv + _cross_soa(qv, uv)) + t  # [..., 3, N]
        d = torch.sqrt((P * P).sum(-2) + 1e-10)
        dinv = 1.0 / d
        r0, r1, r2 = P[..., 0, :] * dinv, P[..., 1, :] * dinv, P[..., 2, :] * dinv
        rk = rdk_t.unbind(-2)
        res = torch.stack([rk[0] - r0, rk[1] - r1, rk[2] - r2, rk[3] - d], dim=-2)
        robust = w_t * torch.sqrt(robust_weight(w_t * res, p))
        z = torch.zeros_like(d)
        jrow = [
            [dinv * (1.0 - r0 * r0), -dinv * r0 * r1, -dinv * r0 * r2, z, r2, -r1, z],
            [-dinv * r1 * r0, dinv * (1.0 - r1 * r1), -dinv * r1 * r2, -r2, z, r0, z],
            [-dinv * r2 * r0, -dinv * r2 * r1, dinv * (1.0 - r2 * r2), r1, -r0, z, z],
            [r0, r1, r2, z, z, z, d],
        ]
        rb = robust.unbind(-2)
        Bm = torch.stack(
            [torch.cat([-rb[r] * jrow[r][a] for r in range(4)], dim=-1) for a in range(7)],
            dim=-2,
        )  # [..., 7, 4N]
        b = (robust * res).flatten(-2)
        H = Bm @ Bm.mT
        g = (Bm @ b[..., None])[..., 0]
        cost = 0.5 * (b * b).sum(-1)
        tau = cholesky_solve(H, -g, reg=p.reg)
        # per stream: a non-PD system gives this stream alone a zero step
        tau = torch.where(torch.isfinite(tau).all(-1, keepdim=True), tau, torch.zeros_like(tau))
        return lie.sim3_retract(T, tau), tau, cost

    return _pose_gn_iterate(solve_step, T_init, p, rel_error, count)


def _pose_gn_iterate(solve_step, T_init, p: GNParams, rel_error: float,
                     count: bool = False):
    """`max_iter` calls of solve_step(T) -> (T_new, tau, cost) under a
    device-side `done` flag (one per stream of T [..., 8]) that freezes the
    pose and the convergence state once JAX's while_loop would have stopped
    (relative cost change under `rel_error` or step norm under
    `delta_thresh`) -> (T, final cost, iterations): the iterations JAX's loop
    would have run (int32, on the device) with `count`, else None."""
    batch = T_init.shape[:-1]
    inf = torch.full(batch, torch.inf, dtype=T_init.dtype, device=T_init.device)
    T, old_cost, new_cost, delta_norm = T_init, inf, inf, inf
    done = torch.zeros(batch, dtype=torch.bool, device=T_init.device)
    iters = torch.zeros(batch, dtype=torch.int32, device=T_init.device) if count else None
    for it in range(p.max_iter):
        if it > 0:
            converged = ((old_cost - new_cost).abs() / (old_cost + 1e-10) < rel_error) | (
                delta_norm < p.delta_thresh
            )
            done = done | converged
        if count:
            iters = iters + (~done).int()
        T_new, tau, cost = solve_step(T)
        T = torch.where(done[..., None], T, T_new)
        old_cost = torch.where(done, old_cost, new_cost)
        new_cost = torch.where(done, new_cost, cost)
        delta_norm = torch.where(done, delta_norm, torch.linalg.vector_norm(tau, dim=-1))
    return T, new_cost, iters


def gauss_newton_pose_calib(
    T_init: torch.Tensor,  # [8] initial T_CkCf
    Xf: torch.Tensor,  # [N, 3] frame points (gathered to keyframe order)
    meas_k: torch.Tensor,  # [N, 3] keyframe measurements [u, v, log z]
    sqrt_info: torch.Tensor,  # [N, 3] whitening (validity and confidence folded in)
    valid_meas: torch.Tensor,  # [N, 1] bool
    K_intr: torch.Tensor,  # [3, 3]
    img_size: tuple[int, int],
    params: GNParams = GNParams(),
):
    """-> (T [8], final cost []): the calibrated tracker's pose solve, a pixel
    + log-depth residual r = meas_k - [u, v, log z](T . Xf) in the same
    structure-of-arrays layout as the rays loop. Pixel rows are
    scale-invariant (row . P = 0) and the log-depth row's scale entry is 1,
    so the chain rule folds without per-point products.

    Conventions of the JAX solver, kept: a projection counts when
    border < u < w-1-border and border < v < h-1-border, strictly (the graph
    solve's gate is border <= u < w-border); log depth is log(max(z, 1e-10)
    + 1e-10), zero where z <= z_eps; the loop stops on its own 1e-3
    relative cost change."""
    p = params
    h_img, w_img = img_size
    fx, fy, cx, cy = K_intr[0, 0], K_intr[1, 1], K_intr[0, 2], K_intr[1, 2]
    Xt, meas_t, w_t = Xf.T, meas_k.T, sqrt_info.T  # [3, N]
    vmeas = valid_meas[:, 0]
    eps = 1e-10  # geometry._EPS

    def solve_step(T):
        t, q, s = T[:3], T[3:7], T[7]
        qv, qw = q[:3, None].expand_as(Xt), q[3]
        uv = 2.0 * _cross_soa(qv, Xt)
        P = s * (Xt + qw * uv + _cross_soa(qv, uv)) + t[:, None]  # [3, N]
        x, y, z = P[0], P[1], P[2]
        zi = 1.0 / (z + eps)
        u = fx * x * zi + cx
        v = fy * y * zi + cy
        gate = ((u > p.pixel_border) & (u < w_img - 1 - p.pixel_border)
                & (v > p.pixel_border) & (v < h_img - 1 - p.pixel_border)
                & (z > p.z_eps) & vmeas).to(T.dtype)
        logz = torch.where(z > p.z_eps, torch.log(torch.clamp(z, min=eps) + eps), 0.0)
        res = torch.stack([meas_t[0] - u, meas_t[1] - v, meas_t[2] - logz]) * gate
        robust = w_t * torch.sqrt(robust_weight(w_t * res, p)) * gate
        zero = torch.zeros_like(z)
        rows = (
            (fx * zi, zero, -fx * x * zi * zi),
            (zero, fy * zi, -fy * y * zi * zi),
            (zero, zero, zi),
        )  # d[u, v, log z]/dP
        # With Jp = [I | -[P]x | P]: a row (p0, p1, p2) gives the rotation
        # block -(p x P) and the scale entry row . P; J = -(...).
        jrow = [[p0, p1, p2, -(p1 * z - p2 * y), -(-p0 * z + p2 * x), -(p0 * y - p1 * x),
                 p0 * x + p1 * y + p2 * z] for p0, p1, p2 in rows]
        Bm = torch.stack(
            [torch.cat([-robust[r] * jrow[r][a] for r in range(3)]) for a in range(7)]
        )  # [7, 3N]
        b = (robust * res).reshape(-1)
        H = Bm @ Bm.T
        g = Bm @ b
        cost = 0.5 * (b * b).sum()
        tau = cholesky_solve(H, -g, reg=p.reg)
        tau = torch.where(torch.isfinite(tau).all(), tau, torch.zeros_like(tau))
        return lie.sim3_retract(T, tau), tau, cost

    T, cost, _ = _pose_gn_iterate(solve_step, T_init, p, 1e-3)
    return T, cost


# ---------------------------------------------------------------------------
# Backend: factor-graph GN over the keyframe arena
# ---------------------------------------------------------------------------
#
# Loop design: as in the pose solve, ``max_iter`` iterations with a device-side
# `done` flag in place of JAX's ``lax.while_loop`` (stop once the step norm is
# under ``delta_thresh``); poses freeze once done, and the host reads nothing.
#
# Assembly: JAX scatter-adds each edge's 7x7 block into the block Hessian.
# Scatter-add with repeated indices is an atomic, run-to-run nondeterministic
# sum on the card, so the port assembles with a product instead:
# D = onehot(jj) - onehot(ii) [E, K] gives H[a, b] = sum_e D[e,a] D[e,b] S_e and
# g = D^T b, one matmul each, the same sums in a fixed order. Two identical
# solves are bit-equal.


def _stride_indices(N: int, stride: int, img_size) -> np.ndarray:
    """Flattened-pixel indices for `point_stride` subsampling: every stride-th
    pixel, with the column phase shifted by (row mod stride) when the image
    shape is known, so the kept pixels form a diagonal lattice."""
    base = np.arange(0, N, stride, dtype=np.int64)
    if img_size is not None:
        h, w = img_size
        if h * w == N:
            base = np.minimum(base + (base // w) % stride, N - 1)
    return base


def _edge_system(Twc, Xi_t, Xj_t, ii, jj, weight_mask, Q, mode: str, K_intr, img_size,
                 p: GNParams, bf16: bool = False):
    """Per-edge 7x7 blocks S [E,7,7], gradients b [E,7] (of pose j; pose i gets
    -b) and the cost, from the pre-gathered points Xi_t / Xj_t [E, 3, N].

    With P = Tij . Xj and left perturbations, the point Jacobian chained with
    Ad(Ti^-1) is expanded analytically:
        (Jp Ad)[r, c] = Ad[r, c] + (-[P]x)[r, :] . Ad[3:6, c] + P_r Ad[6, c].
    S and b are summed over the three residual rows' [E, 7, N] blocks (the
    JAX package's "noconcat" variant). With `bf16` (the "+bf16" variants) the
    square-root weights, residuals and Jacobian rows are rounded to bf16 and
    their products formed in bf16, as JAX stores them; the products are then
    widened to f32 before the contractions, so S and b sum in f32 as JAX's
    `preferred_element_type=float32` does (a bf16 matmul would sum in bf16).

    Modes: "rays", the whitened 3D point error (P - Xi) / sigma_ray;
    "points", the same scaled by 1 / (|Xi| + 1e-6); "calib", the pixel and
    log-depth error of the projections of P and Xi through K_intr [3, 3],
    whitened by sigma_pixel / sigma_depth, counted where both depths exceed
    z_eps and border <= u < w - border, border <= v < h - border (the JAX
    convention, not the pose solve's strict one)."""
    Ti, Tj = Twc[ii], Twc[jj]
    Tij = lie.sim3_mul(lie.sim3_inv(Ti), Tj)
    t, q, s = Tij[:, :3], Tij[:, 3:7], Tij[:, 7:8]
    qv, qw = q[:, :3, None].expand_as(Xj_t), q[:, 3:4, None]
    uv = 2.0 * _cross_soa(qv, Xj_t)
    P = s[:, :, None] * (Xj_t + qw * uv + _cross_soa(qv, uv)) + t[:, :, None]  # [E, 3, N]
    x, y, z = P[:, 0:1], P[:, 1:2], P[:, 2:3]  # [E, 1, N]

    A = lie.sim3_adjoint(lie.sim3_inv(Ti))[..., None]  # [E, 7, 7, 1]
    JpAd = (
        A[:, 0] + z * A[:, 4] - y * A[:, 5] + x * A[:, 6],
        A[:, 1] - z * A[:, 3] + x * A[:, 5] + y * A[:, 6],
        A[:, 2] + y * A[:, 3] - x * A[:, 4] + z * A[:, 6],
    )  # each [E, 7, N]
    if mode in ("rays", "points"):
        sigma_inv = 1.0 / p.sigma_ray
        r = sigma_inv * (P - Xi_t)  # [E, 3, N]
        Jrows = [sigma_inv * J for J in JpAd]
        gate = None
        if mode == "points":
            sc = (1.0 / (torch.sqrt((Xi_t * Xi_t).sum(1)) + 1e-6))[:, None, :]  # [E, 1, N]
            r = r * sc
            Jrows = [sc * J for J in Jrows]
    elif mode == "calib":
        if K_intr is None or img_size is None:
            raise ValueError("the calibrated graph solve needs K_intr and img_size")
        h, w_img = img_size
        fx, fy, cx, cy = K_intr[0, 0], K_intr[1, 1], K_intr[0, 2], K_intr[1, 2]
        sp_inv, sd_inv = 1.0 / p.sigma_pixel, 1.0 / p.sigma_depth
        zi = Xi_t[:, 2]
        zj = z[:, 0]
        zi_safe, zj_safe = torch.clamp(zi, min=1e-6), torch.clamp(zj, min=1e-6)
        zi_inv, zj_inv = 1.0 / zi_safe, 1.0 / zj_safe  # [E, N]
        uj = fx * x[:, 0] * zj_inv + cx
        vj = fy * y[:, 0] * zj_inv + cy
        ui = fx * Xi_t[:, 0] * zi_inv + cx
        vi = fy * Xi_t[:, 1] * zi_inv + cy
        r = torch.stack([sp_inv * (uj - ui), sp_inv * (vj - vi),
                         sd_inv * (torch.log(zj_safe) - torch.log(zi_safe))], dim=1)  # [E, 3, N]
        # The whitened projection rows folded into the JpAd rows:
        # dproj = [[a, 0, -a x/zj], [0, b, -b y/zj], [0, 0, sd_inv/zj]].
        zinv = zj_inv[:, None, :]
        a = sp_inv * fx * zinv
        b2 = sp_inv * fy * zinv
        Jrows = [a * JpAd[0] - (a * x * zinv) * JpAd[2],
                 b2 * JpAd[1] - (b2 * y * zinv) * JpAd[2],
                 (sd_inv * zinv) * JpAd[2]]
        bd = p.pixel_border
        gate = ((zj > p.z_eps) & (zi > p.z_eps) & (uj >= bd) & (uj < w_img - bd)
                & (vj >= bd) & (vj < h - bd)).to(r.dtype)  # [E, N]
    else:
        raise ValueError(f"unknown graph GN mode {mode!r}")
    sqrt_conf = torch.sqrt(torch.clamp(Q, min=0.0))[:, None, :]
    mask = Q * weight_mask if gate is None else Q * weight_mask * gate
    w = robust_weight(sqrt_conf * r, p) * mask[:, None, :]
    sw = torch.sqrt(w)
    if bf16:
        sw, r16, Jrows = sw.bfloat16(), r.bfloat16(), [J.bfloat16() for J in Jrows]
    else:
        r16 = r
    Ak = [(sw[:, k:k + 1] * Jrows[k]).float() for k in range(3)]  # [E, 7, N]
    rk = [(sw[:, k] * r16[:, k]).float() for k in range(3)]  # [E, N]
    S = sum(a @ a.transpose(1, 2) for a in Ak)
    b = sum((a @ v[..., None])[..., 0] for a, v in zip(Ak, rk))
    cost = 0.5 * (w * r * r).sum()
    return S.to(Twc.dtype), b.to(Twc.dtype), cost


def _resolve_edge_chunk(E: int, n_pts: int, edge_chunk: int | None) -> int:
    """Edge-chunk size of the graph solve: the largest chunk whose Jacobian
    transients (~260 B per edge-point in f32) fit a 2 GB budget, shrunk to a
    divisor of E."""
    if edge_chunk is None:
        budget = 2 * 1024**3
        edge_chunk = max(1, min(E, budget // max(n_pts * 260, 1)))
    chunk = min(edge_chunk, E)
    while E % chunk:
        chunk -= 1
    return chunk


def _edge_blocks(Twc_cur, Xi_t, Xj_t, ii, jj, weight_mask, Q, chunk: int, mode: str,
                 K_intr, img_size, p: GNParams, bf16: bool = False):
    """S [E,7,7] and b [E,7], one `_edge_system` per chunk of edges."""
    S, b = [], []
    for c0 in range(0, ii.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        S_c, b_c, _ = _edge_system(Twc_cur, Xi_t[sl], Xj_t[sl], ii[sl], jj[sl],
                                   weight_mask[sl], Q[sl], mode, K_intr, img_size, p, bf16)
        S.append(S_c)
        b.append(b_c)
    return (S[0], b[0]) if len(S) == 1 else (torch.cat(S), torch.cat(b))


def _assemble_Hg(K: int, ii, jj, S, b, dtype):
    """Block Hessian [K, K, 7, 7] and gradient [K, 7] from the edge blocks, by
    the incidence product (deterministic; see the note above)."""
    E = ii.shape[0]
    D = (torch.nn.functional.one_hot(jj, K) - torch.nn.functional.one_hot(ii, K)).to(dtype)
    T = (D[:, :, None] * S.reshape(E, 1, 49)).reshape(E, K * 49)
    H = (D.T @ T).reshape(K, K, 7, 7)
    return H, D.T @ b


def gauss_newton_graph(
    Twc: torch.Tensor,  # [K, 8]
    Xs: torch.Tensor,  # [K, N, 3]
    Cs: torch.Tensor,  # [K, N]
    ii: torch.Tensor,  # [E] int64
    jj: torch.Tensor,  # [E]
    idx_ii2jj: torch.Tensor,  # [E, N]
    valid_match: torch.Tensor,  # [E, N] bool
    Q: torch.Tensor,  # [E, N]
    edge_mask: torch.Tensor,  # [E] bool: inactive edges
    free_mask: torch.Tensor,  # [K] bool: poses the solver may move
    mode: str = "rays",
    K_intr: torch.Tensor | None = None,
    img_size: tuple[int, int] | None = None,
    params: GNParams = GNParams(),
    edge_chunk: int | None = None,
    variant: str = "noconcat",
    point_stride: int = 1,
    mesh=None,
):
    """Global Sim(3) pose-graph GN over dense correspondences -> (Twc_new
    [K, 8], final step norm []), in `mode` "rays", "points" or "calib" (the
    last with intrinsics `K_intr` [3, 3] and `img_size`; the caller has put
    the points on their pixel rays). Pinned poses get an identity diagonal; the
    Levenberg floor is `reg` times max(max|diag H|, 1); a non-finite step is
    replaced by zero. `variant` takes the JAX package's `solve_variant`
    names, read as JAX reads them: "+"-separated words, of which "bf16"
    ("base+bf16", "noconcat+bf16") keeps the edge transients in bf16 with
    f32 sums (`_edge_system`); the rest name the f32 sums, where "base" (one
    concatenated [E, 7, 3N] Jacobian) and "noconcat" are the same sums and
    run the one path here.

    With `mesh` (a `DeviceMesh` with a "dp" axis; every rank passes the same
    arguments) the edge axis shards over the dp ranks: each builds the edge
    blocks of its E/dp edges and assembles its own [K, K, 7, 7] H and [K, 7]
    g, an all-reduce (sum) over dp gives every rank the whole system, and
    the pinning, damping and Cholesky run on every rank, as JAX's shard_map
    does. E must be a multiple of dp (`FactorGraph` pads it)."""
    bf16 = "bf16" in variant.split("+")
    p = params
    K, dtype = Twc.shape[0], Twc.dtype
    if point_stride < 1:
        raise ValueError(f"point_stride must be >= 1, got {point_stride}")
    group = None
    if mesh is not None:
        from mast3r_slam_torch.parallel.mesh import axis_rank, axis_size

        n_dp, r = axis_size(mesh, "dp"), axis_rank(mesh, "dp")
        E = ii.shape[0]
        if E % n_dp:
            raise ValueError(f"edge count {E} not divisible by dp axis {n_dp}")
        mine = slice(r * (E // n_dp), (r + 1) * (E // n_dp))
        ii, jj, idx_ii2jj, valid_match, Q, edge_mask = (
            t[mine] for t in (ii, jj, idx_ii2jj, valid_match, Q, edge_mask))
        group = mesh.get_group("dp")
    ii, jj, idx_ii2jj = ii.long(), jj.long(), idx_ii2jj.long()
    sub = None
    if point_stride > 1:
        sub = torch.as_tensor(_stride_indices(idx_ii2jj.shape[1], point_stride, img_size),
                              device=Twc.device)
        idx_ii2jj, valid_match, Q = idx_ii2jj[:, sub], valid_match[:, sub], Q[:, sub]

    # Pose-independent gathers, once, outside the iterations.
    src = torch.cat([Xs, Cs[..., None]], dim=-1)[ii]  # [E, N, 4]
    gath = torch.gather(src, 1, idx_ii2jj[..., None].expand(-1, -1, 4))
    Xi_t = gath[..., :3].transpose(1, 2)  # [E, 3, Ns]
    Ci = gath[..., 3]
    Xj, Cj = (Xs[jj], Cs[jj]) if sub is None else (Xs[jj][:, sub], Cs[jj][:, sub])
    Xj_t = Xj.transpose(1, 2)
    weight_mask = (valid_match & (Q > p.Q_thresh) & (Ci > p.C_thresh) & (Cj > p.C_thresh)
                   & edge_mask[:, None]).to(dtype)
    freeF = free_mask.to(dtype)
    chunk = _resolve_edge_chunk(ii.shape[0], Xi_t.shape[2], edge_chunk)
    pin_diag = (torch.eye(K, dtype=dtype, device=Twc.device)[:, :, None, None]
                * ((1.0 - freeF)[:, None, None, None] * torch.eye(7, dtype=dtype, device=Twc.device)))

    def step(Twc_cur):
        S, b = _edge_blocks(Twc_cur, Xi_t, Xj_t, ii, jj, weight_mask, Q, chunk, mode, K_intr,
                            img_size, p, bf16)
        H, g = _assemble_Hg(K, ii, jj, S, b, dtype)
        if group is not None:
            torch.distributed.all_reduce(H, group=group)
            torch.distributed.all_reduce(g, group=group)
        H = H * freeF[:, None, None, None] * freeF[None, :, None, None] + pin_diag
        g = g * freeF[:, None]
        H_flat = H.permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
        reg = p.reg * torch.clamp(H_flat.diagonal().abs().max(), min=1.0)
        dx = cholesky_solve(H_flat, -g.reshape(-1), reg=reg).reshape(K, 7) * freeF[:, None]
        dx = torch.where(torch.isfinite(dx).all(), dx, torch.zeros_like(dx))
        Twc_new = torch.where(free_mask[:, None], lie.sim3_retract(Twc_cur, dx), Twc_cur)
        return Twc_new, torch.linalg.vector_norm(dx)

    T = Twc
    delta = torch.full((), torch.inf, dtype=dtype, device=Twc.device)
    done = torch.zeros((), dtype=torch.bool, device=Twc.device)
    for _ in range(p.max_iter):
        T_new, d_new = step(T)
        T = torch.where(done, T, T_new)
        delta = torch.where(done, delta, d_new)
        done = done | (delta < p.delta_thresh)
    return T, delta


class GaussNewtonSolver:
    """Robust Gauss-Newton over a user residual model (JAX's
    ``GaussNewtonSolver``): ``solve(residual_fn, x0 [n], sqrt_info [M])``
    with ``residual_fn(x) -> (r [M], J [M, n])`` in torch ops. Each iteration
    whitens the residuals by `sqrt_info`, reweights them (Huber or Tukey, per
    `params.robust`), solves the normal equations by the damped Cholesky
    (`params.reg`) and takes the Euclidean step x + dx; a step that is not
    finite (a system that is not positive definite) is a zero step.

    JAX runs one ``lax.while_loop`` that stops when the relative cost change
    is under `rel_error` or the step norm under `params.delta_thresh`. Here
    `_pose_gn_iterate` runs `params.max_iter` iterations, and a `done` flag on
    the device freezes x, the cost and the count once that rule fires, so
    the host reads nothing inside `solve` (provided `residual_fn` reads
    nothing either) and the results are the loop's."""

    def __init__(self, params: GNParams = GNParams(), rel_error: float = 1e-3):
        self.p = params
        self.rel_error = rel_error

    def solve(self, residual_fn, x0: torch.Tensor, sqrt_info: torch.Tensor):
        """-> (x [n], final cost [], iterations [] int32), all on x0's device."""
        p = self.p

        def step(x):
            r, J = residual_fn(x)
            rob = sqrt_info * torch.sqrt(robust_weight(sqrt_info * r, p))
            A = rob[:, None] * J
            b = rob * r
            dx = cholesky_solve(A.T @ A, -(A.T @ b), reg=p.reg)
            dx = torch.where(torch.isfinite(dx).all(), dx, torch.zeros_like(dx))
            return x + dx, dx, 0.5 * (b * b).sum()

        return _pose_gn_iterate(step, x0, p, self.rel_error, count=True)
