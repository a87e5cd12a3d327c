"""Two-view correspondence (the port of ``mast3r_slam_tpu/matching.py``).

``matching.method``: "dense" (the shifted-tap matcher of the tracking step,
`ops.dense_match.match_dense_window`), "simple" (warm-start or identity
correspondences and a 3D distance gate, the matcher that "auto" picks with
``use_simple: true``) and "iterative" (projective matching from the warm
start, descriptor refinement and the 3D gate, `match_iterative_proj`, which
"auto" picks with ``use_simple: false``).
"""

from __future__ import annotations

import torch

from mast3r_slam_torch.config import get_config
from mast3r_slam_torch.ops.dense_match import match_dense_window
from mast3r_slam_torch.ops.iter_proj import (fused_dot3, iter_proj, lin_to_pixel,
                                              pixel_to_lin, prep_for_iter_proj, sqrt_rn)
from mast3r_slam_torch.ops.refine import refine_matches


def match(
    X11: torch.Tensor,
    X21: torch.Tensor,
    D11: torch.Tensor,
    D21: torch.Tensor,
    idx_1_to_2_init: torch.Tensor | None = None,
    payload: torch.Tensor | None = None,
    want_hit: bool = False,
):
    """Match pointmaps [B, H, W, 3] of two views per ``get_config().matching``.

    Returns (idx [B, H*W], valid [B, H*W, 1]) plus payload_g [B, H*W, P]
    (`payload` [B, H, W, P] selected at the matches) and/or hit [B, H*W]
    (view-1 pixel claimed by a valid match) when requested. The dense method
    folds both into its tap streams and ignores the warm start
    `idx_1_to_2_init`, as in the JAX package; the simple and iterative
    methods take the payload by one row gather and the hit mask by a
    scatter-max.
    """
    cfg = get_config().matching
    method = cfg.method
    if method == "auto":
        method = "simple" if cfg.use_simple else "iterative"
    if method == "dense":
        return match_dense_window(
            X11, X21, D11, D21,
            radius=cfg.dense_radius,
            dilations=tuple(cfg.dense_dilations),
            desc_weight=cfg.dense_desc_weight,
            dist_thresh=cfg.dist_thresh,
            payload=payload,
            want_hit=want_hit,
        )
    if method == "simple":
        idx, valid = match_simple(X11, X21, idx_1_to_2_init, cfg.dist_thresh)
    elif method == "iterative":
        idx, valid = match_iterative_proj(
            X11, X21, D11, D21, idx_1_to_2_init,
            max_iter=cfg.max_iter,
            lambda_init=cfg.lambda_init,
            convergence_thresh=cfg.convergence_thresh,
            dist_thresh=cfg.dist_thresh,
            use_refine=cfg.use_refine,
            refine_radius=cfg.refine_radius,
            refine_dilation=cfg.refine_dilation,
        )
    else:
        raise ValueError(f"unknown matching.method {method!r}")
    out = [idx, valid]
    if payload is not None:
        b = payload.shape[0]
        pay_flat = payload.reshape(b, -1, payload.shape[-1])
        out.append(torch.gather(pay_flat, 1, idx[..., None].expand(-1, -1, pay_flat.shape[-1])))
    if want_hit:
        out.append(hit_mask(idx, valid))
    return tuple(out)


def hit_mask(idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B, N] bool: the view-1 pixels that a valid match idx [B, N] (valid
    [B, N, 1]) claims. A scatter-max, which is deterministic (the largest
    value wins whatever the order), unlike a scatter-add."""
    hit = torch.zeros(idx.shape, device=idx.device).scatter_reduce(
        1, idx, valid[..., 0].float(), reduce="amax")
    return hit > 0.5


def match_simple(
    X11: torch.Tensor,
    X21: torch.Tensor,
    idx_1_to_2_init: torch.Tensor | None = None,
    dist_thresh: float = 0.1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Warm-start (or identity) correspondences and a 3D distance gate:
    view-2 pixel n matches view-1 pixel idx[n] when |X11[idx[n]] - X21[n]| <
    `dist_thresh` -> (idx [B, H*W] int64, valid [B, H*W, 1])."""
    b, h, w = X21.shape[:3]
    n = h * w
    if idx_1_to_2_init is None:
        idx = torch.arange(n, device=X21.device)[None].expand(b, n)
    else:
        idx = idx_1_to_2_init.long().expand(b, n)
    X11_sampled = torch.gather(X11.reshape(b, n, 3), 1, idx[..., None].expand(b, n, 3))
    diff = X11_sampled - X21.reshape(b, n, 3)
    valid = torch.sqrt((diff * diff).sum(-1)) < dist_thresh
    return idx, valid[..., None]


def match_iterative_proj(
    X11: torch.Tensor,
    X21: torch.Tensor,
    D11: torch.Tensor,
    D21: torch.Tensor,
    idx_1_to_2_init: torch.Tensor | None = None,
    max_iter: int = 10,
    lambda_init: float = 1e-8,
    convergence_thresh: float = 1e-6,
    dist_thresh: float = 0.1,
    use_refine: bool = True,
    refine_radius: int = 3,
    refine_dilation: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Projective matching of view 2's rays onto view 1's ray image from the
    warm start (`ops.iter_proj`), then descriptor refinement (`ops.refine`)
    and the 3D distance gate -> (idx [B, H*W] int64, valid [B, H*W, 1]).
    The sub-pixel positions are truncated to integers, as JAX's int32 cast
    truncates them. Computed as ops/iter_proj.py says, the card's matches
    are the CPU's."""
    b, h, w = X21.shape[:3]
    n = h * w
    rays_with_grad, pts3d_norm, p_init = prep_for_iter_proj(X11, X21, idx_1_to_2_init)
    p1, valid_proj = iter_proj(rays_with_grad, pts3d_norm, p_init, max_iter=max_iter,
                               lambda_init=lambda_init, convergence_thresh=convergence_thresh)
    p1_int = p1.long()
    if use_refine and refine_radius > 0:
        p1_int = refine_matches(D11, D21.reshape(b, n, -1), p1_int, radius=refine_radius,
                                dilation_max=refine_dilation)
    u = torch.clamp(p1_int[..., 0], 0, w - 1)
    v = torch.clamp(p1_int[..., 1], 0, h - 1)
    idx = pixel_to_lin(torch.stack([u, v], dim=-1), w)
    X11_sampled = torch.gather(X11.reshape(b, n, 3), 1, idx[..., None].expand(b, n, 3))
    diff = X11_sampled - X21.reshape(b, n, 3)
    valid = valid_proj & (sqrt_rn(fused_dot3(diff, diff)) < dist_thresh)
    return idx, valid[..., None]


__all__ = [
    "match",
    "match_simple",
    "match_iterative_proj",
    "lin_to_pixel",
    "pixel_to_lin",
]
