"""Result export: TUM / KITTI trajectories, PLY point clouds, and the ATE
metric (the port's copy of ``mast3r_slam_tpu/utils/export.py``: the same
file layouts, so evo and other downstream tools read either package's
output)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from mast3r_slam_torch.lie import core as lie


def save_trajectory_tum(path, timestamps, poses_sim3: np.ndarray) -> None:
    """TUM format: `timestamp tx ty tz qx qy qz qw` per line."""
    path = Path(path)
    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses_sim3):
            t, q = T[:3], T[3:7]
            f.write(
                f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def save_trajectory_kitti(path, poses_sim3: np.ndarray) -> None:
    """KITTI format: flattened 3x4 matrix per line."""
    path = Path(path)
    mats = lie.sim3_matrix(torch.as_tensor(np.asarray(poses_sim3, np.float32))).numpy()
    with open(path, "w") as f:
        for T in mats:
            f.write(" ".join(f"{x:.6f}" for x in T[:3, :].flatten()) + "\n")


def save_ply(path, points: np.ndarray, colors: np.ndarray) -> None:
    """ASCII PLY with uchar RGB."""
    path = Path(path)
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors)
    if colors.dtype != np.uint8:
        colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")


def load_trajectory_tum(path) -> tuple[np.ndarray, np.ndarray]:
    """Read a TUM trajectory -> (timestamps [N], poses [N, 8] Sim3 s=1)."""
    rows = []
    ts = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(x) for x in line.split()]
        ts.append(vals[0])
        rows.append(vals[1:8] + [1.0])
    return np.asarray(ts), np.asarray(rows, np.float32)


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """Absolute trajectory error (RMSE of translations) after Umeyama
    Sim(3) alignment, the standard SLAM accuracy metric."""
    est = np.asarray(est_poses)[:, :3].T  # [3, N]
    gt = np.asarray(gt_poses)[:, :3].T
    mu_e = est.mean(axis=1, keepdims=True)
    mu_g = gt.mean(axis=1, keepdims=True)
    e = est - mu_e
    g = gt - mu_g
    cov = g @ e.T / est.shape[1]
    U, S, Vt = np.linalg.svd(cov)
    W = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        W[2, 2] = -1
    R = U @ W @ Vt
    var_e = (e**2).sum() / est.shape[1]
    s = np.trace(np.diag(S) @ W) / max(var_e, 1e-12)
    t = mu_g - s * R @ mu_e
    aligned = s * R @ est + t
    return float(np.sqrt(((aligned - gt) ** 2).sum(axis=0).mean()))
