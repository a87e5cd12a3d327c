"""Dense shifted-tap matching (the port of ``mast3r_slam_tpu/ops/dense_match.py``).

For every view-2 pixel the candidates are its own coordinates displaced by a
fixed tap lattice (`window_taps`); each tap is one dense comparison between
the view-2 ray/descriptor images and a shifted view-1 image. Plain PyTorch
ops for now: the JAX package left this loop to XLA, and a hand kernel for it
is ROADMAP queue 2 work.

Numerics follow what the JAX program computes as XLA executes it: rays,
descriptors and the payload are rounded to bf16 once (BIG = 1e30 marks
out-of-bounds taps), and the per-tap arithmetic (ray difference, its square
and sum, the descriptor product and its sum) is f32. The JAX source writes
the difference and the product as bf16 ops followed by a cast to f32, but
XLA is allowed excess precision there and does not round them (measured on
the CPU backend: its argmin picks are those of the unrounded costs, and
differ from a bf16-rounded reading at ~3% of pixels of a smooth scene). A
tap replaces the best so far only if its cost is strictly lower, so the
first tap in `window_taps` order wins ties. The view-1 images are padded
once by the lattice's reach and each tap reads a slice of them.
"""

from __future__ import annotations

import torch

from mast3r_slam_torch.geometry import normalize_rays

BIG = 1e30


def window_taps(radius: int, dilations: tuple[int, ...]) -> list[tuple[int, int]]:
    """Union of dilated windows as (du, dv), deduplicated in insertion order."""
    taps: dict[tuple[int, int], None] = {}
    for dil in dilations:
        for oy in range(-radius, radius + 1):
            for ox in range(-radius, radius + 1):
                taps[(ox * dil, oy * dil)] = None
    return list(taps)


def _pad_hw(img: torch.Tensor, r: int, fill: float) -> torch.Tensor:
    """[B, H, W, C] -> [B, H+2r, W+2r, C] with a constant border."""
    b, h, w, c = img.shape
    out = img.new_full((b, h + 2 * r, w + 2 * r, c), fill)
    out[:, r : r + h, r : r + w] = img
    return out


def match_dense_window(
    X11: torch.Tensor,
    X21: torch.Tensor,
    D11: torch.Tensor,
    D21: torch.Tensor,
    radius: int = 6,
    dilations: tuple[int, ...] = (1,),
    desc_weight: float = 1.0,
    dist_thresh: float = 0.1,
    payload: torch.Tensor | None = None,
    want_hit: bool = False,
):
    """Match view-2 pixels to view-1 pixels over the tap window.

    Args:
        X11 / X21: pointmaps [B, H, W, 3] (view-1 frame)
        D11 / D21: unit descriptors [B, H, W, D]
        payload: optional [B, H, W, P] view-1 values selected at the winning
            tap (bf16, like the other streams)
        want_hit: also return hit [B, H*W] bool: view-1 pixel claimed by at
            least one valid match (the scatter-max of `valid` over `idx`)

    Returns:
        (idx [B, H*W] int64, valid [B, H*W, 1] bool), then payload_g
        [B, H*W, P] and/or hit [B, H*W] when requested.
    """
    b, h, w, _ = X11.shape
    n = h * w
    taps = window_taps(radius, dilations)
    r = max(max(abs(du), abs(dv)) for du, dv in taps)
    bf16 = torch.bfloat16

    def stream(x):  # rounded to bf16 once, computed on in f32
        return x.to(bf16).float()

    rays1 = _pad_hw(stream(normalize_rays(X11)), r, float(torch.tensor(BIG, dtype=bf16)))
    rays2 = stream(normalize_rays(X21))
    desc1 = _pad_hw(stream(D11), r, 0.0)
    desc2 = stream(D21)
    pay1 = None if payload is None else _pad_hw(payload.to(bf16), r, 0.0)

    best_cost = X11.new_full((b, h, w), BIG, dtype=torch.float32)
    best_du = torch.zeros((b, h, w), dtype=torch.int64, device=X11.device)
    best_dv = torch.zeros_like(best_du)
    best_pay = None if pay1 is None else pay1.new_zeros((b, h, w, pay1.shape[-1]))

    for du, dv in taps:
        ys, xs = slice(r + dv, r + dv + h), slice(r + du, r + du + w)
        diff = rays1[:, ys, xs] - rays2
        cost = (diff * diff).sum(-1)
        if desc_weight > 0:
            sim = (desc1[:, ys, xs] * desc2).sum(-1)
            cost = cost - desc_weight * sim
        cost = torch.where(cost < BIG, cost, BIG)
        take = cost < best_cost
        best_cost = torch.where(take, cost, best_cost)
        best_du = torch.where(take, du, best_du)
        best_dv = torch.where(take, dv, best_dv)
        if best_pay is not None:
            best_pay = torch.where(take[..., None], pay1[:, ys, xs], best_pay)

    xx = torch.arange(w, device=X11.device)[None, None, :]
    yy = torch.arange(h, device=X11.device)[None, :, None]
    u = torch.clamp(xx + best_du, 0, w - 1)
    v = torch.clamp(yy + best_dv, 0, h - 1)
    idx = (v * w + u).reshape(b, n)

    # Occlusion gate at the winning displacement.
    Xm = torch.gather(X11.reshape(b, n, 3), 1, idx[..., None].expand(b, n, 3))
    dist = torch.linalg.vector_norm(Xm - X21.reshape(b, n, 3), dim=-1)
    valid = (dist < dist_thresh) & (best_cost.reshape(b, n) < BIG)

    out = [idx, valid[..., None]]
    if best_pay is not None:
        out.append(best_pay.reshape(b, n, -1))
    if want_hit:
        hit = torch.zeros((b, n), dtype=torch.float32, device=X11.device)
        hit.scatter_reduce_(1, idx, valid.float(), reduce="amax")
        out.append(hit > 0.5)
    return tuple(out)
