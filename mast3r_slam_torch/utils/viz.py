"""Offline renders of a run (the port of ``mast3r_slam_tpu/utils/viz.py``):
the trajectory in three projections and a subsampled coloured point cloud,
written as PNG with matplotlib's Agg backend (no display)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(poses_sim3: np.ndarray, out_path: str | Path,
                    gt_poses: np.ndarray | None = None, title: str = "trajectory") -> None:
    """XY / XZ / YZ projections of a [N, 8] Sim(3) trajectory (and of a
    ground-truth one, dashed)."""
    plt = _pyplot()
    t = np.asarray(poses_sim3)[:, :3]
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    for ax, (i, j, name) in zip(axes, [(0, 1, "XY"), (0, 2, "XZ"), (1, 2, "YZ")]):
        ax.plot(t[:, i], t[:, j], "-", lw=1.0, label="estimate")
        ax.plot(t[0, i], t[0, j], "go", ms=6, label="start")
        ax.plot(t[-1, i], t[-1, j], "rs", ms=6, label="end")
        if gt_poses is not None:
            g = np.asarray(gt_poses)[:, :3]
            ax.plot(g[:, i], g[:, j], "--", lw=1.0, alpha=0.7, label="gt")
        ax.set_title(f"{title} ({name})")
        ax.set_aspect("equal", adjustable="datalim")
        ax.grid(alpha=0.3)
    axes[0].legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_pointcloud(points: np.ndarray, colors: np.ndarray, out_path: str | Path,
                    max_points: int = 100_000, elev: float = -60.0, azim: float = -90.0) -> None:
    """A coloured 3D scatter of the map, subsampled to `max_points` with a
    seeded draw."""
    plt = _pyplot()
    points, colors = np.asarray(points), np.asarray(colors)
    if colors.dtype == np.uint8:
        colors = colors.astype(np.float32) / 255.0
    if len(points) > max_points:
        sel = np.random.default_rng(0).choice(len(points), max_points, replace=False)
        points, colors = points[sel], colors[sel]
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=colors, s=0.3, alpha=0.6)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def render_run(slam, out_dir: str | Path) -> list[Path]:
    """Render a finished `SLAM` run's trajectory and map into `out_dir`;
    returns the files written."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = slam._get_results()
    paths = []
    if slam.poses:
        p = out_dir / "trajectory.png"
        plot_trajectory(np.stack([T.cpu().numpy() for T in slam.poses]), p)
        paths.append(p)
    if len(results["points"]):
        p = out_dir / "pointcloud.png"
        plot_pointcloud(results["points"], results["colors"], p)
        paths.append(p)
    return paths
