"""Lie groups for the port: the functional core (`lie.core`) and the group
classes `SO3`, `SE3`, `Sim3` (`lie.groups`).

Layouts: quaternion ``[qx, qy, qz, qw]`` (Hamilton), SE3 ``[t(3), q(4)]``
with tangent ``[v, w]``, Sim3 ``[t(3), q(4), s(1)]`` with tangent
``[v, w, sigma]``; one retraction convention, left: ``exp(xi) * T``.
"""

from mast3r_slam_torch.lie import core
from mast3r_slam_torch.lie.core import (
    point_jacobian,
    quat_conj,
    quat_mul,
    quat_rotate,
    quat_to_matrix,
    se3_exp,
    se3_log,
    sim3_act,
    sim3_adjoint,
    sim3_exp,
    sim3_identity,
    sim3_inv,
    sim3_log,
    sim3_matrix,
    sim3_mul,
    sim3_relative,
    sim3_retract,
    so3_exp,
    so3_log,
)
from mast3r_slam_torch.lie.groups import SE3, SO3, Sim3

__all__ = [
    "core",
    "quat_mul",
    "quat_conj",
    "quat_rotate",
    "quat_to_matrix",
    "so3_exp",
    "so3_log",
    "se3_exp",
    "se3_log",
    "sim3_identity",
    "sim3_exp",
    "sim3_log",
    "sim3_inv",
    "sim3_mul",
    "sim3_act",
    "sim3_matrix",
    "sim3_adjoint",
    "sim3_retract",
    "sim3_relative",
    "point_jacobian",
    "SO3",
    "SE3",
    "Sim3",
]
