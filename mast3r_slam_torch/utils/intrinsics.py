"""Intrinsics from a pointmap, for calibration-free runs (the port of
``mast3r_slam_tpu/utils/intrinsics.py``).

A MASt3R mono pointmap fixes the focal: pixel (u, v) with camera point
(x, y, z) satisfies u - cx = f x / z and v - cy = f y / z, so f solves a 1-D
weighted least squares over the pixels. It starts at the median of the
per-pixel estimates and takes 10 Weiszfeld reweighting steps, a fixed loop
on the device; the caller reads the focal once, to print it.

The median is JAX's `nanmedian` (linear interpolation): with an even number
of valid pixels it averages the two middle values, where `torch.nanmedian`
returns the lower one. The start changes the answer (10 Weiszfeld steps do
not always absorb it), so `_nanmedian` computes JAX's.
"""

from __future__ import annotations

import torch

from mast3r_slam_torch.geometry import get_pixel_coords


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of a 1-D tensor, as `jnp.nanmedian`:
    sorted with NaNs last, position 0.5 (n - 1), the two neighbours weighted
    linearly. NaN when every entry is NaN. No host read."""
    s = torch.sort(x).values
    n = (~torch.isnan(s)).sum().to(x.dtype)
    pos = 0.5 * (n - 1.0)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1.0 - w_hi

    def at(i):
        return s[torch.clamp(torch.minimum(i, n - 1.0), min=0.0).long()]

    return at(lo) * w_lo + at(hi) * w_hi


def estimate_focal(X: torch.Tensor, img_size: tuple[int, int], conf: torch.Tensor | None = None,
                   iters: int = 10) -> torch.Tensor:
    """Focal length in pixels [] from a camera-frame pointmap X [H*W, 3],
    principal point at the image centre; `conf` [H*W, 1] (>= 1) weights the
    pixels by conf - 1."""
    h, w = img_size
    X = X.float()
    uv = get_pixel_coords(1, img_size, dtype=X.dtype, device=X.device).reshape(-1, 2)
    duv = uv - torch.tensor([w / 2.0, h / 2.0], dtype=X.dtype, device=X.device)
    z = torch.clamp(X[:, 2:3], min=1e-6)
    xy_over_z = X[:, :2] / z

    base_w = torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)
    if conf is not None:
        base_w = base_w * torch.clamp(conf.float() - 1.0, min=0.0)
    base_w = base_w * (X[:, 2:3] > 1e-6).to(X.dtype)

    dot = (duv * xy_over_z).sum(-1, keepdim=True)
    nrm = (xy_over_z * xy_over_z).sum(-1, keepdim=True)
    ok = (nrm[:, 0] > 1e-8) & (base_w[:, 0] > 0)
    f = _nanmedian(torch.where(ok, dot[:, 0] / torch.clamp(nrm[:, 0], min=1e-8), torch.nan))
    for _ in range(iters):
        d = duv - f * xy_over_z
        r = torch.sqrt((d * d).sum(-1, keepdim=True))
        wgt = base_w / torch.clamp(r, min=1e-3)
        f = (wgt * dot).sum() / torch.clamp((wgt * nrm).sum(), min=1e-8)
    return f


def estimate_intrinsics(X: torch.Tensor, img_size: tuple[int, int],
                        conf: torch.Tensor | None = None) -> torch.Tensor:
    """K [3, 3] f32 on X's device: the estimated focal on both axes and the
    principal point at the image centre."""
    h, w = img_size
    f = estimate_focal(X, img_size, conf)
    K = torch.zeros((3, 3), dtype=torch.float32, device=X.device)
    K[0, 0] = K[1, 1] = f
    K[0, 2], K[1, 2], K[2, 2] = w / 2.0, h / 2.0, 1.0
    return K
