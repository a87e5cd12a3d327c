"""Ray-distance geometry (the port of the parts of
``mast3r_slam_tpu/geometry.py`` that the tracking step uses)."""

from __future__ import annotations

import torch

_EPS = 1e-10


def point_to_dist(X: torch.Tensor) -> torch.Tensor:
    """Euclidean norm with the reference's epsilon: sqrt(|X|^2 + 1e-10)."""
    return torch.sqrt((X * X).sum(-1, keepdim=True) + _EPS)


def normalize_rays(X: torch.Tensor) -> torch.Tensor:
    return X / point_to_dist(X)


def point_to_ray_dist(X: torch.Tensor) -> torch.Tensor:
    """[..., 3] point -> [..., 4] ray-distance [rx, ry, rz, d]."""
    d = point_to_dist(X)
    return torch.cat([X * (1.0 / d), d], dim=-1)


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
