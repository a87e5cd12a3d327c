"""Lie group classes over tensors (the port of
``mast3r_slam_tpu/lie/groups.py``): immutable views over the functional core
(`lie.core`) with the same methods, exp / log / inv / * / act / matrix /
retr, as plain classes (the JAX classes are also pytrees; nothing here
needs that)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mast3r_slam_torch.lie import core


@dataclass(frozen=True)
class SO3:
    """Unit-quaternion rotation, data [..., 4] = [qx, qy, qz, qw]."""

    data: torch.Tensor

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32, device=None) -> "SO3":
        q = torch.zeros(*batch_shape, 4, dtype=dtype, device=device)
        q[..., 3] = 1.0
        return cls(q)

    @classmethod
    def exp(cls, phi: torch.Tensor) -> "SO3":
        return cls(core.so3_exp(phi))

    def log(self) -> torch.Tensor:
        return core.so3_log(self.data)

    def inv(self) -> "SO3":
        return SO3(core.quat_conj(self.data))

    def __mul__(self, other: "SO3") -> "SO3":
        return SO3(core.quat_mul(self.data, other.data))

    def act(self, p: torch.Tensor) -> torch.Tensor:
        return core.quat_rotate(self.data, p)

    def matrix(self) -> torch.Tensor:
        return core.quat_to_matrix(self.data)

    def retr(self, phi: torch.Tensor) -> "SO3":
        return SO3.exp(phi) * self


@dataclass(frozen=True)
class SE3:
    """Rigid transform, data [..., 7] = [t(3), q(4)]."""

    data: torch.Tensor

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32, device=None) -> "SE3":
        e = torch.zeros(*batch_shape, 7, dtype=dtype, device=device)
        e[..., 6] = 1.0
        return cls(e)

    @classmethod
    def exp(cls, xi: torch.Tensor) -> "SE3":
        return cls(core.se3_exp(xi))

    def log(self) -> torch.Tensor:
        return core.se3_log(self.data)

    @property
    def translation(self) -> torch.Tensor:
        return self.data[..., :3]

    @property
    def rotation(self) -> SO3:
        return SO3(self.data[..., 3:7])

    def inv(self) -> "SE3":
        q_inv = core.quat_conj(self.data[..., 3:7])
        t_inv = -core.quat_rotate(q_inv, self.data[..., :3])
        return SE3(torch.cat([t_inv, q_inv], dim=-1))

    def __mul__(self, other: "SE3") -> "SE3":
        ta, qa = self.data[..., :3], self.data[..., 3:7]
        tb, qb = other.data[..., :3], other.data[..., 3:7]
        t = core.quat_rotate(qa, tb) + ta
        return SE3(torch.cat([t, core.quat_mul(qa, qb)], dim=-1))

    def act(self, p: torch.Tensor) -> torch.Tensor:
        return core.quat_rotate(self.data[..., 3:7], p) + self.data[..., :3]

    def matrix(self) -> torch.Tensor:
        R = core.quat_to_matrix(self.data[..., 3:7])
        top = torch.cat([R, self.data[..., :3, None]], dim=-1)
        bottom = torch.zeros_like(top[..., :1, :])
        bottom[..., 0, 3] = 1.0
        return torch.cat([top, bottom], dim=-2)

    def retr(self, xi: torch.Tensor) -> "SE3":
        return SE3.exp(xi) * self


@dataclass(frozen=True)
class Sim3:
    """Similarity transform, data [..., 8] = [t(3), q(4), s(1)]."""

    data: torch.Tensor

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32, device=None) -> "Sim3":
        return cls(core.sim3_identity(batch_shape, dtype, device))

    @classmethod
    def exp(cls, xi: torch.Tensor) -> "Sim3":
        return cls(core.sim3_exp(xi))

    def log(self) -> torch.Tensor:
        return core.sim3_log(self.data)

    @property
    def translation(self) -> torch.Tensor:
        return self.data[..., :3]

    @property
    def rotation(self) -> SO3:
        return SO3(self.data[..., 3:7])

    @property
    def scale(self) -> torch.Tensor:
        return self.data[..., 7:8]

    def inv(self) -> "Sim3":
        return Sim3(core.sim3_inv(self.data))

    def __mul__(self, other: "Sim3") -> "Sim3":
        return Sim3(core.sim3_mul(self.data, other.data))

    def act(self, p: torch.Tensor) -> torch.Tensor:
        return core.sim3_act(self.data, p)

    def matrix(self) -> torch.Tensor:
        return core.sim3_matrix(self.data)

    def adjoint(self) -> torch.Tensor:
        return core.sim3_adjoint(self.data)

    def retr(self, xi: torch.Tensor) -> "Sim3":
        """Left retraction exp(xi) * self."""
        return Sim3(core.sim3_retract(self.data, xi))
