"""Frames, pointmap fusion, the keyframe arena and the SLAM state (the port of
``mast3r_slam_tpu/frame.py``).

The keyframe arena is a fixed-capacity, preallocated store on the device of
stacked keyframe state (points, confidences, poses, fusion counts, encoder
features), as in the JAX package. Where JAX donates a buffer to a jitted
slot write, the port writes the slot in place (`Tensor.copy_`); where JAX
compacts with one gather after an eviction, the port shifts the higher slots
down one from a copy of the source, since source and destination overlap.
As in JAX, the slots past the last live one duplicate the tail. At capacity
512 and 512x384 the arena holds X 1.2 GB, C 0.4 GB and bf16 features 0.8 GB,
which the card holds whole.

Host mirrors (fusion counts, update counts, scores, frame ids, images) save
a device read per access, as in JAX; `version` is bumped by every mutation so
consumers may cache slices against it.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from mast3r_slam_torch.config import get_config
from mast3r_slam_torch.device import resolve_device
from mast3r_slam_torch.geometry import cartesian_to_spherical, spherical_to_cartesian
from mast3r_slam_torch.lie import Sim3, core as lie


class Mode(enum.Enum):
    INIT = 0
    TRACKING = 1
    RELOC = 2
    TERMINATED = 3


def fuse_pointmap(X_old, C_old, X_new, C_new, mode: str = "weighted_pointmap"):
    """Merge a new observation ([N, 3], [N, 1]) into the canonical pointmap.

    Modes: "recent", "indep_conf", "weighted_pointmap", "weighted_spherical".
    """
    if mode == "recent":
        return X_new, C_new
    if mode == "indep_conf":
        take_new = C_new > C_old
        return torch.where(take_new, X_new, X_old), torch.where(take_new, C_new, C_old)
    if mode == "weighted_pointmap":
        C_tot = C_old + C_new
        return (C_old * X_old + C_new * X_new) / torch.clamp(C_tot, min=1e-12), C_tot
    if mode == "weighted_spherical":
        C_tot = C_old + C_new
        s = (C_old * cartesian_to_spherical(X_old) + C_new * cartesian_to_spherical(X_new))
        return spherical_to_cartesian(s / torch.clamp(C_tot, min=1e-12)), C_tot
    raise ValueError(f"unknown filtering mode {mode!r}")


def fuse_pointmap_masked(X_old, C_old, N_old, X_new, C_new, mode: str = "weighted_pointmap"):
    """Fusion where a count N_old < 0.5 (first observation) takes the new
    observation as is, decided on the device. Returns (X, C, N). The
    pointmaps may carry a leading batch dimension [B, N, *] with one count
    per stream, N_old [B] (the serving path, where JAX vmaps this)."""
    X_f, C_f = fuse_pointmap(X_old, C_old, X_new, C_new, mode)
    first = N_old < 0.5
    first_pts = first.reshape(first.shape + (1,) * (X_new.dim() - first.dim()))
    X = torch.where(first_pts, X_new, X_f)
    C = torch.where(first_pts, C_new, C_f)
    if mode.startswith("weighted"):
        N = torch.where(first, torch.ones_like(N_old), N_old + 1.0)
    else:
        N = torch.ones_like(N_old)
    return X, C, N


@dataclasses.dataclass
class Frame:
    """One frame's state on the device (image in [0, 1])."""

    frame_id: int
    img: torch.Tensor  # [H, W, 3] float32
    T_WC: Optional[torch.Tensor] = None  # Sim3 [8]
    X_canon: Optional[torch.Tensor] = None  # [N, 3]
    C: Optional[torch.Tensor] = None  # [N, 1]
    feat: Optional[torch.Tensor] = None  # [S, D] encoder tokens
    pos: Optional[torch.Tensor] = None  # [S, 2] patch positions
    N: int = 0
    N_updates: int = 0
    _score: Optional[float] = None
    K: Optional[torch.Tensor] = None  # [3, 3] intrinsics (calibrated mode)

    def __post_init__(self):
        if self.T_WC is None:
            self.T_WC = lie.sim3_identity(device=self.img.device)

    @property
    def T_WC_sim3(self) -> Sim3:
        return Sim3(self.T_WC)

    def get_score(self, C: torch.Tensor) -> float:
        if get_config().tracking.filtering_score == "median":
            return float(torch.quantile(C.float().reshape(-1), 0.5))
        return float(C.mean())

    def update_pointmap(self, X: torch.Tensor, C: torch.Tensor) -> None:
        mode = get_config().tracking.filtering_mode
        if self.N == 0:
            self.X_canon, self.C, self.N, self.N_updates = X, C, 1, 1
            if mode == "best_score":
                self._score = self.get_score(C)
            return
        if mode == "first":
            if self.N_updates == 1:
                self.X_canon, self.C, self.N = X, C, 1
        elif mode == "best_score":
            new_score = self.get_score(C)
            if new_score > (self._score or 0.0):
                self.X_canon, self.C, self.N, self._score = X, C, 1, new_score
        else:
            self.X_canon, self.C = fuse_pointmap(self.X_canon, self.C, X, C, mode)
            self.N = self.N + 1 if mode.startswith("weighted") else 1
        self.N_updates += 1

    def get_average_conf(self) -> Optional[torch.Tensor]:
        return None if self.C is None else self.C / self.N


def create_frame(frame_id: int, img, T_WC=None, device=None) -> Frame:
    """A Frame from a [H, W, 3] uint8 or float image (numpy or tensor), on
    `device` (default: the image's own)."""
    img = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img) else img)
    if device is not None:
        img = img.to(device)
    img = img.float() / 255.0 if img.dtype == torch.uint8 else img.float()
    if img.dim() == 3 and img.shape[0] == 3:  # tolerate CHW input
        img = img.permute(1, 2, 0)
    return Frame(frame_id=frame_id, img=img, T_WC=T_WC)


def _arena_remove(buf: torch.Tensor, idx: int) -> None:
    """Close the gap at slot `idx` in place: slots above it move down one, the
    last slot keeps its value (so it duplicates the new tail). The copy's
    source and destination overlap, hence the clone."""
    buf[idx:-1] = buf[idx + 1:].clone()


class Keyframes:
    """Fixed-capacity keyframe store on `device` (default: the card, raising
    without CUDA): append / remove / pop_last / last_index / last_keyframe /
    __getitem__ / write_pointmap / write_pose / update_T_WCs, the live
    slices get_poses / get_points / get_confidences, and the intrinsics K [3, 3]
    of calibrated mode (`set_intrinsics` / `get_intrinsics`). Writes are in-place slot
    copies. `__getitem__` returns a Frame whose pose is a copy and whose
    pointmap, confidence and features are views of the arena: a caller that
    keeps them past the next write of that slot, or past an eviction, copies
    them first."""

    def __init__(self, h: int, w: int, capacity: int | None = None, dtype=torch.float32,
                 device=None):
        cfg = get_config()
        self.h, self.w = h, w
        self.capacity = capacity or cfg.runtime.keyframe_capacity
        self.dtype = dtype
        self.device = resolve_device(device)
        n, cap = h * w, self.capacity
        kw = dict(dtype=dtype, device=self.device)
        self.X = torch.zeros((cap, n, 3), **kw)
        self.C = torch.zeros((cap, n, 1), **kw)
        self.T_WC = lie.sim3_identity((cap,), device=self.device)
        self.N = torch.zeros((cap, 1, 1), **kw)  # fusion counts
        self._n_host: list[float] = [0.0] * cap
        self._nups_host: list[int] = [0] * cap
        self._score_host: list[Optional[float]] = [None] * cap
        self._feat: Optional[torch.Tensor] = None  # [cap, S, D], sized at first append
        self._pos: Optional[torch.Tensor] = None
        self.frame_ids: list[int] = []
        self.imgs: list[torch.Tensor] = []
        self.K: Optional[torch.Tensor] = None  # [3, 3] intrinsics (calibrated mode)
        self.version: int = 0

    def __len__(self) -> int:
        return len(self.frame_ids)

    @property
    def count(self) -> int:
        return len(self.frame_ids)

    def _ensure_feat(self, feat: torch.Tensor) -> None:
        if self._feat is None:
            s, d = feat.shape[-2:]
            self._feat = torch.zeros((self.capacity, s, d), dtype=feat.dtype, device=self.device)

    def remove(self, idx: int) -> None:
        """Evict keyframe `idx` and compact the arena (higher slots move down one)."""
        count = len(self.frame_ids)
        if not 0 <= idx < count:
            raise IndexError(f"keyframe {idx} not live (count={count})")
        self.frame_ids.pop(idx)
        self.imgs.pop(idx)
        for mirror, empty in ((self._n_host, 0.0), (self._nups_host, 0), (self._score_host, None)):
            mirror.pop(idx)
            mirror.append(empty)
        for buf in (self.X, self.C, self.T_WC, self.N, self._feat):
            if buf is not None:
                _arena_remove(buf, idx)
        self.version += 1

    def append(self, frame: Frame) -> int:
        idx = len(self.frame_ids)
        assert idx < self.capacity, "keyframe arena full"
        self.frame_ids.append(frame.frame_id)
        self.imgs.append(frame.img)
        self.X[idx].copy_(frame.X_canon)
        self.C[idx].copy_(frame.C)
        self.T_WC[idx].copy_(frame.T_WC)
        self.N[idx].fill_(float(frame.N))
        self._n_host[idx] = float(frame.N)
        self._nups_host[idx] = int(frame.N_updates)
        self._score_host[idx] = frame._score
        if frame.feat is not None:
            self._ensure_feat(frame.feat)
            self._feat[idx].copy_(frame.feat)
            self._pos = frame.pos
        self.version += 1
        return idx

    def pop_last(self) -> None:
        if self.frame_ids:
            self.frame_ids.pop()
            self.imgs.pop()
            self.version += 1

    def last_index(self) -> Optional[int]:
        return len(self.frame_ids) - 1 if self.frame_ids else None

    def last_keyframe(self) -> Optional[Frame]:
        idx = self.last_index()
        return None if idx is None else self[idx]

    def __getitem__(self, idx: int) -> Frame:
        f = Frame(
            frame_id=self.frame_ids[idx], img=self.imgs[idx], T_WC=self.T_WC[idx].clone(),
            X_canon=self.X[idx], C=self.C[idx],
            feat=None if self._feat is None else self._feat[idx], pos=self._pos,
            N=int(self._n_host[idx]), K=self.K,
        )
        nups = self._nups_host[idx]
        f.N_updates = nups if nups > 0 else f.N
        f._score = self._score_host[idx]
        return f

    def write_pointmap(self, idx: int, X: torch.Tensor, C: torch.Tensor, n_count: float,
                       n_updates: int | None = None, score: float | None = None) -> None:
        self.X[idx].copy_(X)
        self.C[idx].copy_(C)
        self.N[idx].fill_(n_count)
        self._n_host[idx] = float(n_count)
        if n_updates is not None:
            self._nups_host[idx] = int(n_updates)
        if score is not None:
            self._score_host[idx] = float(score)
        self.version += 1

    def write_pose(self, idx: int, T: torch.Tensor) -> None:
        self.T_WC[idx].copy_(T)
        self.version += 1

    def update_T_WCs(self, T_WCs: torch.Tensor, indices) -> None:
        """Batch pose write-back (backend solve); `indices` are distinct."""
        self.T_WC[torch.as_tensor(np.asarray(indices), device=self.device)] = T_WCs
        self.version += 1

    def get_poses(self) -> torch.Tensor:
        """[count, 8] poses of the live keyframes (a view of the arena)."""
        return self.T_WC[: len(self)]

    def get_points(self) -> torch.Tensor:
        """[count, N, 3] canonical pointmaps of the live keyframes (a view)."""
        return self.X[: len(self)]

    def get_confidences(self) -> torch.Tensor:
        """[count, N, 1] average confidences C / max(N, 1) of the live keyframes."""
        return self.get_average_conf_arena()[: len(self)]

    def get_average_conf_arena(self) -> torch.Tensor:
        """[capacity, N, 1] average confidences over the whole arena (for masked use)."""
        return self.C / torch.clamp(self.N, min=1.0)

    def set_intrinsics(self, K: torch.Tensor) -> None:
        self.K = K

    def get_intrinsics(self) -> Optional[torch.Tensor]:
        return self.K


@dataclasses.dataclass
class SLAMState:
    """Pipeline mode and the host-side work queues."""

    mode: Mode = Mode.INIT
    global_optimizer_tasks: list[int] = dataclasses.field(default_factory=list)
    reloc_pending: int = 0  # carried by snapshots, as in JAX

    def queue_global_optimization(self, idx: int) -> None:
        self.global_optimizer_tasks.append(idx)

    def dequeue_global_optimization(self) -> Optional[int]:
        return self.global_optimizer_tasks.pop(0) if self.global_optimizer_tasks else None

    def queue_reloc(self) -> None:
        self.reloc_pending += 1

    def dequeue_reloc(self) -> bool:
        """Take one pending relocalisation -> whether there was one."""
        if self.reloc_pending > 0:
            self.reloc_pending -= 1
            return True
        return False
