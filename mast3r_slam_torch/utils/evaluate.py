"""Trajectory evaluation against ground truth in TUM format: ATE and RPE
(the port of ``mast3r_slam_tpu/utils/evaluate.py``).

    python -m mast3r_slam_torch.utils.evaluate estimate.txt groundtruth.txt
"""

from __future__ import annotations

import numpy as np

from mast3r_slam_torch.utils.export import ate_rmse, load_trajectory_tum


def associate_trajectories(ts_a: np.ndarray, ts_b: np.ndarray,
                           max_dt: float = 0.02) -> tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-timestamp association (the TUM benchmark convention):
    for each stamp of `ts_a` the nearest of `ts_b` within `max_dt` (the
    earlier of two at equal distance) -> index arrays (ia, ib)."""
    ia, ib = [], []
    order = np.argsort(ts_b)
    ts_b_sorted = ts_b[order]
    for i, t in enumerate(ts_a):
        j = np.searchsorted(ts_b_sorted, t)
        best, best_dt = None, max_dt
        for cand in (j - 1, j):
            if 0 <= cand < len(ts_b_sorted):
                dt = abs(ts_b_sorted[cand] - t)
                if dt <= best_dt:
                    best, best_dt = cand, dt
        if best is not None:
            ia.append(i)
            ib.append(order[best])
    return np.asarray(ia, int), np.asarray(ib, int)


def rpe_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1) -> float:
    """Relative pose error: the RMSE of `delta`-step translation increments
    after one least-squares scale (monocular scale is free)."""
    et = np.asarray(est_poses)[:, :3]
    gt = np.asarray(gt_poses)[:, :3]
    d_e = et[delta:] - et[:-delta]
    d_g = gt[delta:] - gt[:-delta]
    s = np.sum(d_e * d_g) / max(np.sum(d_e * d_e), 1e-12)
    err = s * d_e - d_g
    return float(np.sqrt((err ** 2).sum(axis=-1).mean()))


def evaluate_tum(est_path, gt_path, max_dt: float = 0.02) -> dict:
    """Two TUM trajectory files -> {ate_rmse, rpe_rmse, n_matched}."""
    ts_e, est = load_trajectory_tum(est_path)
    ts_g, gt = load_trajectory_tum(gt_path)
    ia, ib = associate_trajectories(ts_e, ts_g, max_dt)
    if ia.size < 2:
        raise ValueError("fewer than 2 associated poses")
    return {"ate_rmse": ate_rmse(est[ia], gt[ib]), "rpe_rmse": rpe_rmse(est[ia], gt[ib]),
            "n_matched": int(ia.size)}


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="python -m mast3r_slam_torch.utils.evaluate",
                                 description="TUM trajectory evaluation")
    ap.add_argument("estimate")
    ap.add_argument("groundtruth")
    ap.add_argument("--max-dt", type=float, default=0.02)
    args = ap.parse_args(argv)
    print(json.dumps(evaluate_tum(args.estimate, args.groundtruth, args.max_dt)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
