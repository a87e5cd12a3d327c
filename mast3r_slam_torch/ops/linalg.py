"""Small dense solves for the Gauss-Newton loops (the port of
``mast3r_slam_tpu/ops/linalg.py``): the damped Cholesky solve of the pose
and graph solvers, the closed-form 2x2 and 3x3 solves, and the Schur
complement solve of a pose/landmark system with a diagonal landmark block.
Each is batched over leading dimensions, with JAX's damping and determinant
clamps."""

from __future__ import annotations

import torch


def cholesky_solve(H: torch.Tensor, g: torch.Tensor, reg: float = 1e-6) -> torch.Tensor:
    """Solve (H + reg*I) x = g for symmetric PSD H, batched over leading dims.

    Where H + reg*I is not positive definite the result is NaN, as with
    JAX's Cholesky, so that callers' finiteness guards catch it.
    ``torch.linalg.cholesky`` would raise (and sync with the host) there;
    ``cholesky_ex`` reports the failure in `info` instead.
    """
    n = H.shape[-1]
    L, info = torch.linalg.cholesky_ex(H + reg * torch.eye(n, dtype=H.dtype, device=H.device))
    y = torch.linalg.solve_triangular(L, g[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]
    return torch.where((info == 0)[..., None], x, torch.nan)


def solve_2x2(A: torch.Tensor, b: torch.Tensor, damping: float = 0.0) -> torch.Tensor:
    """Closed-form solve of (A + damping*I) x = b, A [..., 2, 2], b [..., 2].
    A determinant below 1e-10 in magnitude becomes sign(det)*1e-10 + 1e-10."""
    a11, a12 = A[..., 0, 0] + damping, A[..., 0, 1]
    a21, a22 = A[..., 1, 0], A[..., 1, 1] + damping
    det = a11 * a22 - a12 * a21
    det = torch.where(det.abs() < 1e-10, torch.sign(det) * 1e-10 + 1e-10, det)
    inv_det = 1.0 / det
    x0 = (a22 * b[..., 0] - a12 * b[..., 1]) * inv_det
    x1 = (-a21 * b[..., 0] + a11 * b[..., 1]) * inv_det
    return torch.stack([x0, x1], dim=-1)


def solve_3x3(A: torch.Tensor, b: torch.Tensor, damping: float = 0.0) -> torch.Tensor:
    """Closed-form solve of (A + damping*I) x = b by the adjugate, A [..., 3,
    3], b [..., 3]. A determinant below 1e-12 in magnitude becomes 1e-12."""
    A = A + damping * torch.eye(3, dtype=A.dtype, device=A.device)

    def a(i, j):
        return A[..., i, j]

    c00 = a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1)
    c01 = a(1, 2) * a(2, 0) - a(1, 0) * a(2, 2)
    c02 = a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0)
    det = a(0, 0) * c00 + a(0, 1) * c01 + a(0, 2) * c02
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    adj = torch.stack([
        torch.stack([c00, a(0, 2) * a(2, 1) - a(0, 1) * a(2, 2),
                     a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1)], dim=-1),
        torch.stack([c01, a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0),
                     a(0, 2) * a(1, 0) - a(0, 0) * a(1, 2)], dim=-1),
        torch.stack([c02, a(0, 1) * a(2, 0) - a(0, 0) * a(2, 1),
                     a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)], dim=-1),
    ], dim=-2)
    return (adj @ b[..., None])[..., 0] / det[..., None]


def sparse_schur_solve(Hpp: torch.Tensor, Hpl: torch.Tensor, Hll_diag: torch.Tensor,
                       gp: torch.Tensor, gl: torch.Tensor,
                       reg: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve [[Hpp, Hpl], [Hpl^T, diag(Hll_diag)]] [xp; xl] = [gp; gl] by
    eliminating the landmarks: Hpp [P, P], Hpl [P, L], Hll_diag [L], gp [P],
    gl [L] -> (xp [P], xl [L]). The landmark block is damped by `reg`, and
    the pose Schur complement is solved by `cholesky_solve` with `reg`."""
    Hll_inv = 1.0 / (Hll_diag + reg)
    HplW = Hpl * Hll_inv[None, :]
    S = Hpp - HplW @ Hpl.T
    xp = cholesky_solve(S, gp - HplW @ gl, reg=reg)
    xl = Hll_inv * (gl - Hpl.T @ xp)
    return xp, xl
