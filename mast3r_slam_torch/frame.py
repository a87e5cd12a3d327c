"""Pointmap fusion (the port of ``fuse_pointmap`` / ``fuse_pointmap_masked``
in ``mast3r_slam_tpu/frame.py``). The keyframe arena and SLAM state of that
module are not ported yet (ROADMAP queue 1)."""

from __future__ import annotations

import torch

from mast3r_slam_torch.geometry import cartesian_to_spherical, spherical_to_cartesian


def fuse_pointmap(X_old, C_old, X_new, C_new, mode: str = "weighted_pointmap"):
    """Merge a new observation ([N, 3], [N, 1]) into the canonical pointmap.

    Modes: "recent", "indep_conf", "weighted_pointmap", "weighted_spherical".
    """
    if mode == "recent":
        return X_new, C_new
    if mode == "indep_conf":
        take_new = C_new > C_old
        return torch.where(take_new, X_new, X_old), torch.where(take_new, C_new, C_old)
    if mode == "weighted_pointmap":
        C_tot = C_old + C_new
        return (C_old * X_old + C_new * X_new) / torch.clamp(C_tot, min=1e-12), C_tot
    if mode == "weighted_spherical":
        C_tot = C_old + C_new
        s = (C_old * cartesian_to_spherical(X_old) + C_new * cartesian_to_spherical(X_new))
        return spherical_to_cartesian(s / torch.clamp(C_tot, min=1e-12)), C_tot
    raise ValueError(f"unknown filtering mode {mode!r}")


def fuse_pointmap_masked(X_old, C_old, N_old, X_new, C_new, mode: str = "weighted_pointmap"):
    """Fusion where a count N_old < 0.5 (first observation) takes the new
    observation as is, decided on the device. Returns (X, C, N)."""
    X_f, C_f = fuse_pointmap(X_old, C_old, X_new, C_new, mode)
    first = N_old < 0.5
    X = torch.where(first, X_new, X_f)
    C = torch.where(first, C_new, C_f)
    if mode.startswith("weighted"):
        N = torch.where(first, torch.ones_like(N_old), N_old + 1.0)
    else:
        N = torch.ones_like(N_old)
    return X, C, N
