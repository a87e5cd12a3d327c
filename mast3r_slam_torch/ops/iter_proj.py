"""Iterative projective matching (the port of
``mast3r_slam_tpu/ops/iter_proj.py``).

For every view-2 point, taken as a unit ray, find the view-1 pixel whose
bilinearly sampled ray matches it: a damped 2D Levenberg-Marquardt step per
point on the [B, H, W, 9] image of view 1's rays and their central-difference
gradients. The loop runs `max_iter` steps without reading anything back to
the host: a point whose step fell under `convergence_thresh` is frozen and
stops moving, as in the JAX package.

Plain PyTorch, as the JAX package leaves this to XLA: a per-point gather
chase with no hand kernel behind it there either.

Numerics kept from the JAX function, since the iteration amplifies last-bit
differences: the sample coordinate is clamped to `w - 1.001` (and `h -
1.001`) and the 2x2 anchor is clipped to `w - 2` as integers as well; the
block is reduced along x within each row first, then along y; the 3-vector
dot products add their terms in order. XLA contracts the multiply-adds of
this arithmetic into fused multiply-adds, one rounding each (read off its
results on the CPU: the bilinear weights, the dot products, the rays'
squared norms, the 2x2 determinant and the two solution terms); the port
computes the same fused operations with `torch.addcmul`, which rounds once
on the CPU and on the card. From the same inputs the two packages' pixels
then agree to 8e-6 px after 10 steps (2e-4 px unfused).

The card and the CPU compute the same bits here, because the iteration is
chaotic on a random-weight pointmap (one float32 step on every input moves
half of a full-width frame's matches): no reduction kernel runs (one may add
in another order on the card), and the rays' norms take `sqrt_rn`, since a
1-ulp difference of the card's float32 square root moved 11% of them.
"""

from __future__ import annotations

import torch

from mast3r_slam_torch.geometry import img_gradient


def lin_to_pixel(idx: torch.Tensor, w: int) -> torch.Tensor:
    """Linear index -> (u, v)."""
    return torch.stack([idx % w, idx // w], dim=-1)


def pixel_to_lin(p: torch.Tensor, w: int) -> torch.Tensor:
    """(u, v) -> linear index."""
    return p[..., 0] + w * p[..., 1]


def fused_dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product of the last axis (3) as XLA computes it: a fused
    multiply-add chain in component order."""
    acc = torch.addcmul(a[..., 0] * b[..., 0], a[..., 1], b[..., 1])
    return torch.addcmul(acc, a[..., 2], b[..., 2])


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded to nearest on every device. The card's
    float32 `torch.sqrt` is not (1 ulp off at 0.7% of random inputs on an
    H100); float64's is, and rounding its result to float32 again gives the
    correctly rounded float32 root (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.double()).float()


def _unit_rays(X: torch.Tensor) -> torch.Tensor:
    """`geometry.normalize_rays` with the squared norm as `fused_dot3` and
    the root as `sqrt_rn`."""
    return X / sqrt_rn(fused_dot3(X, X)[..., None] + 1e-10)


def prep_for_iter_proj(X11: torch.Tensor, X21: torch.Tensor,
                       idx_1_to_2_init: torch.Tensor | None):
    """-> (rays_with_grad [B, H, W, 9] = view 1's rays | d/dx | d/dy, view 2's
    unit rays [B, H*W, 3], start pixels [B, H*W, 2] from the warm start, or
    each pixel's own coordinates)."""
    b, h, w, _ = X11.shape
    rays = _unit_rays(X11)
    gx, gy = img_gradient(rays)
    rays_with_grad = torch.cat([rays, gx, gy], dim=-1)
    pts3d_norm = _unit_rays(X21.reshape(b, -1, 3))
    if idx_1_to_2_init is None:
        idx_1_to_2_init = torch.arange(h * w, device=X11.device)[None].expand(b, h * w)
    p_init = lin_to_pixel(idx_1_to_2_init.long().expand(b, h * w), w).float()
    return rays_with_grad, pts3d_norm, p_init


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img [B, H, W, C] sampled at coords [B, N, 2] (u, v) -> [B, N, C], the
    coordinates clamped to the interpolation domain."""
    b, h, w, c = img.shape
    if h < 2 or w < 2:
        raise ValueError(f"bilinear block gather needs h, w >= 2; got {h}x{w}")
    x = torch.clamp(coords[..., 0], 0.0, w - 1.001)
    y = torch.clamp(coords[..., 1], 0.0, h - 1.001)
    # The float clamp keeps x0 <= w - 2 only while w - 1.001 rounds below
    # w - 1 in f32; the integer clip keeps the 2x2 block in bounds at any size.
    x0 = torch.clamp(torch.floor(x).long(), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).long(), 0, h - 2)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    lin = y0 * w + x0  # [B, N]
    corners = torch.stack([lin, lin + 1, lin + w, lin + w + 1], dim=-1).reshape(b, -1)
    v = img.reshape(b, h * w, c)[torch.arange(b, device=img.device)[:, None], corners]
    v00, v01, v10, v11 = v.reshape(b, -1, 4, c).unbind(2)  # (y, x) = 00, 01, 10, 11
    row0 = torch.addcmul(v00 * (1.0 - fx), v01, fx)
    row1 = torch.addcmul(v10 * (1.0 - fx), v11, fx)
    return torch.addcmul(row0 * (1.0 - fy), row1, fy)


def iter_proj(rays_with_grad: torch.Tensor, pts3d_norm: torch.Tensor, p_init: torch.Tensor,
              max_iter: int = 10, lambda_init: float = 1e-8,
              convergence_thresh: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point LM projection of unit rays pts3d_norm [B, N, 3] onto the ray
    image rays_with_grad [B, H, W, 9] from p_init [B, N, 2] -> (p [B, N, 2]
    clamped to the image, valid [B, N]: the unclamped p was inside it)."""
    _, h, w, _ = rays_with_grad.shape
    thresh_sq = convergence_thresh * convergence_thresh
    p = p_init.float()
    frozen = torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device)
    for _ in range(max_iter):
        sampled = bilinear_sample(rays_with_grad, p)
        r = sampled[..., 0:3] - pts3d_norm
        gx, gy = sampled[..., 3:6], sampled[..., 6:9]
        a11 = fused_dot3(gx, gx) + lambda_init
        a12 = fused_dot3(gx, gy)
        a22 = fused_dot3(gy, gy) + lambda_init
        b1, b2 = fused_dot3(gx, r), fused_dot3(gy, r)
        inv_det = 1.0 / torch.clamp(torch.addcmul(-(a12 * a12), a11, a22), min=1e-10)
        dx = -torch.addcmul(-(a12 * b2), a22, b1) * inv_det
        dy = -torch.addcmul(-a12 * b1, a11, b2) * inv_det
        p = p + torch.where(frozen[..., None], 0.0, torch.stack([dx, dy], dim=-1))
        frozen = frozen | (torch.addcmul(dx * dx, dy, dy) < thresh_sq)
    u, v = p[..., 0], p[..., 1]
    valid = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    return torch.stack([torch.clamp(u, 0, w - 1), torch.clamp(v, 0, h - 1)], dim=-1), valid
