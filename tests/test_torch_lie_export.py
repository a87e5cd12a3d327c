"""The Lie-group and geometry helpers the backend and the export use
(`lie.sim3_adjoint`, `lie.sim3_matrix`, `geometry.constrain_points_to_ray`)
and `utils/export.py`, against the JAX package's on numpy-seeded inputs.

Tolerances: the helpers within 1e-5 (f32, other operation orders); the
exported files byte-equal; ATE within 1e-9 (f64 on both sides).
"""

import numpy as np
import torch

from mast3r_slam_tpu import geometry as jax_geometry
from mast3r_slam_tpu.lie import core as jax_lie
from mast3r_slam_tpu.utils import export as jax_export
from mast3r_slam_torch import geometry
from mast3r_slam_torch.lie import core as lie
from mast3r_slam_torch.utils import export


def _sim3(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([rng.normal(size=(n, 3)), q, rng.uniform(0.5, 2, (n, 1))],
                          axis=-1).astype(np.float32)


def test_sim3_matrix_and_adjoint_match_jax():
    T = _sim3(np.random.default_rng(0), 6)
    for port, ref in ((lie.sim3_matrix, jax_lie.sim3_matrix),
                      (lie.sim3_adjoint, jax_lie.sim3_adjoint)):
        np.testing.assert_allclose(port(torch.from_numpy(T)).numpy(), np.asarray(ref(T)),
                                   atol=1e-5, rtol=0)
    # Ad_T xi = log(T exp(xi) T^-1) to first order: a small-step check
    xi = (np.random.default_rng(1).normal(size=(6, 7)) * 1e-3).astype(np.float32)
    Tt = torch.from_numpy(T).double()
    lhs = lie.sim3_mul(lie.sim3_mul(Tt, lie.sim3_exp(torch.from_numpy(xi).double())),
                       lie.sim3_inv(Tt))
    rhs = lie.sim3_exp((lie.sim3_adjoint(Tt) @ torch.from_numpy(xi).double()[..., None])[..., 0])
    lhs_m, rhs_m = lie.sim3_matrix(lhs), lie.sim3_matrix(rhs)
    assert (lhs_m - rhs_m).abs().max().item() < 1e-5


def test_constrain_points_to_ray_matches_jax():
    rng = np.random.default_rng(2)
    h, w = 6, 8
    Xs = rng.normal(size=(2, h * w, 3)).astype(np.float32)
    Xs[..., 2] = np.abs(Xs[..., 2]) + 0.5
    K = np.array([[50.0, 0, 3.5], [0, 48.0, 2.5], [0, 0, 1]], np.float32)
    out = geometry.constrain_points_to_ray((h, w), torch.from_numpy(Xs), torch.from_numpy(K))
    ref = jax_geometry.constrain_points_to_ray((h, w), Xs, K)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_export_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    poses = _sim3(rng, 5)
    stamps = [0.0, 0.5, 1.25, 2.0, 3.5]
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (20, 3)).astype(np.uint8)
    for name, port, ref in (
        ("traj.tum", lambda p: export.save_trajectory_tum(p, stamps, poses),
         lambda p: jax_export.save_trajectory_tum(p, stamps, poses)),
        ("traj.kitti", lambda p: export.save_trajectory_kitti(p, poses),
         lambda p: jax_export.save_trajectory_kitti(p, poses)),
        ("cloud.ply", lambda p: export.save_ply(p, pts, cols),
         lambda p: jax_export.save_ply(p, pts, cols)),
    ):
        port(tmp_path / f"port_{name}")
        ref(tmp_path / f"jax_{name}")
        assert (tmp_path / f"port_{name}").read_bytes() == (tmp_path / f"jax_{name}").read_bytes()

    ts, loaded = export.load_trajectory_tum(tmp_path / "port_traj.tum")
    ts_j, loaded_j = jax_export.load_trajectory_tum(tmp_path / "jax_traj.tum")
    np.testing.assert_array_equal(ts, ts_j)
    np.testing.assert_array_equal(loaded, loaded_j)
    gt = poses.astype(np.float64).copy()
    gt[:, :3] += rng.normal(0, 0.01, (5, 3))
    assert abs(export.ate_rmse(poses, gt) - jax_export.ate_rmse(poses, gt)) < 1e-9
