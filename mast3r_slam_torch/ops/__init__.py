"""Device ops of the port: the attention kernel, the dense and iterative
matchers, the Gauss-Newton solvers and their dense solves. The top level
exports the JAX package's ``ops`` names."""

from mast3r_slam_torch.ops.gauss_newton import (
    GNParams,
    gauss_newton_graph,
    gauss_newton_pose_calib,
    gauss_newton_pose_rays,
    huber_weight,
)
from mast3r_slam_torch.ops.iter_proj import iter_proj, prep_for_iter_proj
from mast3r_slam_torch.ops.linalg import cholesky_solve, solve_2x2, solve_3x3, sparse_schur_solve
from mast3r_slam_torch.ops.refine import refine_matches

__all__ = [
    "iter_proj",
    "prep_for_iter_proj",
    "refine_matches",
    "GNParams",
    "gauss_newton_graph",
    "gauss_newton_pose_calib",
    "gauss_newton_pose_rays",
    "huber_weight",
    "cholesky_solve",
    "solve_2x2",
    "solve_3x3",
    "sparse_schur_solve",
]
