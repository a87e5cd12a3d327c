"""Descriptor refinement of matches (the port of ``mast3r_slam_tpu/ops/refine.py``).

Each match moves to the pixel of a (2r+1)^2 window around it, taps spaced by
the dilation, whose view-1 descriptor has the largest dot product with the
query descriptor from view 2; coarse to fine over dilations `dilation_max`,
..., 1.

The JAX function gathers the whole window as one [B, N, (2r+1)^2, D] tensor
(0.9 GB at 196,608 points, 49 taps and 24-d f32 descriptors, per batch row).
Here the taps are a loop: each is one [B, N, D] gather and a dot product, and
a tap replaces the best so far only when its score is strictly greater, so
the first tap in window order (v-major, u fastest) wins ties, as
`jnp.argmax` picks the first maximum. Taps outside the image score -inf.

Scores are summed in float64 from the descriptors' float32 products, which
are exact there: the order a device's reduction adds in then moves a score
by ~1e-16 relative, so the card and the CPU pick the same tap unless two
taps tie to that precision, where each picks the first. JAX sums in float32
and parts from this only where two taps' scores lie within float32
rounding of each other.
"""

from __future__ import annotations

import torch


def refine_matches_step(D11: torch.Tensor, D21: torch.Tensor, p1: torch.Tensor,
                        radius: int = 3, dilation: int = 1) -> torch.Tensor:
    """One window search: D11 [B, H, W, D] view-1 descriptors, D21 [B, N, D]
    queries, p1 [B, N, 2] integer (u, v) -> refined positions [B, N, 2]."""
    b, h, w, d = D11.shape
    flat = D11.reshape(b, h * w, d)
    query = D21.double()
    rows = torch.arange(b, device=D11.device)[:, None]
    u0, v0 = p1[..., 0], p1[..., 1]
    best = torch.full(u0.shape, -torch.inf, dtype=torch.float64, device=D11.device)
    # a window of -inf scores keeps its first tap, as argmax picks it
    best_u, best_v = u0 - radius * dilation, v0 - radius * dilation
    for oy in range(-radius, radius + 1):
        for ox in range(-radius, radius + 1):
            u, v = u0 + ox * dilation, v0 + oy * dilation
            inside = (u >= 0) & (u < w) & (v >= 0) & (v < h)
            lin = torch.clamp(v, 0, h - 1) * w + torch.clamp(u, 0, w - 1)
            score = torch.linalg.vecdot(flat[rows, lin].double(), query)
            score = torch.where(inside, score, -torch.inf)
            better = score > best
            best = torch.where(better, score, best)
            best_u = torch.where(better, u, best_u)
            best_v = torch.where(better, v, best_v)
    return torch.stack([best_u, best_v], dim=-1)


def refine_matches(D11: torch.Tensor, D21: torch.Tensor, p1: torch.Tensor, radius: int = 3,
                   dilation_max: int = 1) -> torch.Tensor:
    """Coarse to fine: dilations `dilation_max`, ..., 2, 1 -> [B, N, 2] int64."""
    p = p1.long()
    for dil in range(max(1, dilation_max), 0, -1):
        p = refine_matches_step(D11, D21, p, radius=radius, dilation=dil)
    return p
