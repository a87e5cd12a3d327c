"""Two-view correspondence (the port of ``mast3r_slam_tpu/matching.py``).

Only ``matching.method: dense`` is ported (the matcher of the tracking
step). The "simple" and "iterative" methods raise NotImplementedError until
ROADMAP queue 1 ports them.
"""

from __future__ import annotations

import torch

from mast3r_slam_torch.config import get_config
from mast3r_slam_torch.ops.dense_match import match_dense_window


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

    Returns (idx [B, H*W], valid [B, H*W, 1]) plus payload_g and/or hit when
    requested; see `ops.dense_match.match_dense_window`. The dense method
    ignores the warm start `idx_1_to_2_init`, as in the JAX package.
    """
    cfg = get_config().matching
    method = cfg.method
    if method == "auto":
        method = "simple" if cfg.use_simple else "iterative"
    if method != "dense":
        raise NotImplementedError(
            f"matching.method={method!r} is not ported yet (ROADMAP queue 1); "
            "the port runs matching.method='dense'"
        )
    return match_dense_window(
        X11, X21, D11, D21,
        radius=cfg.dense_radius,
        dilations=tuple(cfg.dense_dilations),
        desc_weight=cfg.dense_desc_weight,
        dist_thresh=cfg.dist_thresh,
        payload=payload,
        want_hit=want_hit,
    )
