"""Lie groups for the port: the functional core (`lie.core`).

The object wrappers of ``mast3r_slam_tpu/lie/groups.py`` are not ported yet
(ROADMAP queue 1 item 4).
"""

from mast3r_slam_torch.lie import core

__all__ = ["core"]
