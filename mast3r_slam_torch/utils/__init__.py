"""Host utilities of the port: result export and the ATE metric, SLAM
snapshots, per-run metrics, profiling, trajectory evaluation and plots."""

from mast3r_slam_torch.utils.export import (ate_rmse, load_trajectory_tum, save_ply,
                                            save_trajectory_kitti, save_trajectory_tum)
from mast3r_slam_torch.utils.profiling import StageTimer, trace

__all__ = [
    "ate_rmse",
    "load_trajectory_tum",
    "save_ply",
    "save_trajectory_kitti",
    "save_trajectory_tum",
    "StageTimer",
    "trace",
]
