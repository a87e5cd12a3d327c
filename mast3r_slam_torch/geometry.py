"""Ray-distance and pinhole geometry with analytic Jacobians, and image
gradients (the port of ``mast3r_slam_tpu/geometry.py``)."""

from __future__ import annotations

import torch

from mast3r_slam_torch.lie import core as lie

_EPS = 1e-10


def skew_sym(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> the cross-product matrix [..., 3, 3] ([v]x w = v x w)."""
    return lie.skew(v)


def point_to_dist(X: torch.Tensor) -> torch.Tensor:
    """Euclidean norm with the reference's epsilon: sqrt(|X|^2 + 1e-10)."""
    return torch.sqrt((X * X).sum(-1, keepdim=True) + _EPS)


def normalize_rays(X: torch.Tensor) -> torch.Tensor:
    return X / point_to_dist(X)


def point_to_ray_dist(X: torch.Tensor, jacobian: bool = False):
    """[..., 3] point -> [..., 4] ray-distance [rx, ry, rz, d]; with
    `jacobian` also d[r, d]/dX [..., 4, 3]: dr/dX = (I - r r^T) / d and
    dd/dX = r^T."""
    d = point_to_dist(X)
    d_inv = 1.0 / d
    r = X * d_inv
    rd = torch.cat([r, d], dim=-1)
    if not jacobian:
        return rd
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(*X.shape[:-1], 3, 3)
    dr_dX = d_inv[..., None] * (eye - r[..., :, None] * r[..., None, :])
    return rd, torch.cat([dr_dX, r[..., None, :]], dim=-2)


def act_Sim3(T_data: torch.Tensor, p: torch.Tensor, jacobian: bool = False):
    """Points p [..., 3] moved by the Sim3 T_data [..., 8] (broadcast); with
    `jacobian` also the left-perturbation Jacobian d(exp(xi) T p)/dxi
    [..., 3, 7] = [I | -[pW]x | pW]."""
    pW = lie.sim3_act(T_data, p)
    if not jacobian:
        return pW
    return pW, lie.point_jacobian(pW)


def cartesian_to_spherical(P: torch.Tensor) -> torch.Tensor:
    r = point_to_dist(P)
    x, y, z = P[..., 0:1], P[..., 1:2], P[..., 2:3]
    phi = torch.atan2(y, x)
    theta = torch.arccos(torch.clamp(z / r, -1.0, 1.0))
    return torch.cat([r, phi, theta], dim=-1)


def spherical_to_cartesian(S: torch.Tensor) -> torch.Tensor:
    r, phi, theta = S[..., 0:1], S[..., 1:2], S[..., 2:3]
    st = torch.sin(theta)
    return torch.cat(
        [r * st * torch.cos(phi), r * st * torch.sin(phi), r * torch.cos(theta)], dim=-1
    )


def get_pixel_coords(batch_size: int, img_size: tuple[int, int], dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """[B, H, W, 2] grid of (u, v) pixel coordinates."""
    h, w = img_size
    vg, ug = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device), indexing="ij")
    return torch.stack([ug, vg], dim=-1).expand(batch_size, h, w, 2)


def decompose_K(K: torch.Tensor):
    """(fx, fy, cx, cy) of intrinsics [..., 3, 3]. As in the JAX package, K is
    the [3, 3] matrix (or a batch of them); a [4] vector is not accepted."""
    if K.dim() < 2 or K.shape[-2:] != (3, 3):
        raise ValueError(f"intrinsics must be [..., 3, 3], got {tuple(K.shape)}")
    return K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]


def project_calib(P: torch.Tensor, K: torch.Tensor, img_size: tuple[int, int],
                  jacobian: bool = False, border: int = 0, z_eps: float = 0.0):
    """Project points P [..., 3] through K [3, 3] -> ([u, v, log z] [..., 3],
    valid [..., 1]), and with `jacobian` the pinhole chain d[u, v, log z]/dP
    [..., 3, 3] between them. Valid: border < u < w-1-border,
    border < v < h-1-border and z > z_eps; log z is
    log(max(z, 1e-10) + 1e-10), and 0 where z <= z_eps."""
    h, w = img_size
    fx, fy, cx, cy = decompose_K(K)
    x, y, z = P.unbind(-1)
    z_inv = 1.0 / (z + _EPS)
    u = fx * x * z_inv + cx
    v = fy * y * z_inv + cy
    valid_z = z > z_eps
    valid = ((u > border) & (u < w - 1 - border) & (v > border) & (v < h - 1 - border)
             & valid_z)[..., None]
    logz = torch.where(valid_z, torch.log(torch.clamp(z, min=_EPS) + _EPS), 0.0)
    pz = torch.stack([u, v, logz], dim=-1)
    if not jacobian:
        return pz, valid
    zero = torch.zeros_like(z)
    J = torch.stack([
        torch.stack([fx * z_inv, zero, -fx * x * z_inv * z_inv], dim=-1),
        torch.stack([zero, fy * z_inv, -fy * y * z_inv * z_inv], dim=-1),
        torch.stack([zero, zero, z_inv], dim=-1),
    ], dim=-2)
    return pz, J, valid


def backproject(p: torch.Tensor, z: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels p [..., 2] at depths z [..., 1] -> camera points [..., 3]."""
    fx, fy, cx, cy = decompose_K(K)
    x = (p[..., 0:1] - cx) / fx * z
    y = (p[..., 1:2] - cy) / fy * z
    return torch.cat([x, y, z], dim=-1)


def constrain_points_to_ray(img_size: tuple[int, int], Xs: torch.Tensor,
                            K: torch.Tensor) -> torch.Tensor:
    """Snap [B, H*W, 3] points onto their pixel rays, keeping depth
    (calibrated mode)."""
    b = Xs.shape[0]
    uv = get_pixel_coords(b, img_size, dtype=Xs.dtype, device=Xs.device).reshape(b, -1, 2)
    return backproject(uv, Xs[..., 2:3], K)


def img_gradient(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients (d/dx, d/dy) of [B, H, W, C] images, zero
    on the border columns and rows."""
    gx = torch.nn.functional.pad((img[:, :, 2:] - img[:, :, :-2]) * 0.5, (0, 0, 1, 1))
    gy = torch.nn.functional.pad((img[:, 2:] - img[:, :-2]) * 0.5, (0, 0, 0, 0, 1, 1))
    return gx, gy
