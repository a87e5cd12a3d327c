"""Small dense solves for the Gauss-Newton loops (the port of
``cholesky_solve`` in ``mast3r_slam_tpu/ops/linalg.py``)."""

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
