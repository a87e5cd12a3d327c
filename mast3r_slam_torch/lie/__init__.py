"""Lie groups for the port: the functional core (`lie.core`) and the group
classes `SO3`, `SE3`, `Sim3` (`lie.groups`).

Layouts: quaternion ``[qx, qy, qz, qw]`` (Hamilton), SE3 ``[t(3), q(4)]``
with tangent ``[v, w]``, Sim3 ``[t(3), q(4), s(1)]`` with tangent
``[v, w, sigma]``; one retraction convention, left: ``exp(xi) * T``.
"""

from mast3r_slam_torch.lie import core
from mast3r_slam_torch.lie.groups import SE3, SO3, Sim3

__all__ = ["core", "SO3", "SE3", "Sim3"]
