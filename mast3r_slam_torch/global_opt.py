"""Backend factor graph: dense-correspondence pose-graph optimisation over the
keyframe arena (the port of ``mast3r_slam_tpu/global_opt.py``).

Edge state lives in a fixed-capacity arena on the device (`local_opt.max_edges`
bounds it), with the edge lists on the host. `add_factors` matches all the
requested keyframe pairs in one symmetric decode (`mast3r_match_symmetric`)
and reads one vector of match fractions back. A solve gathers the keyframes
the edges touch and runs `ops.gauss_newton.gauss_newton_graph`.

Sizes: JAX pads the keyframe and edge counts to power-of-two buckets so that
XLA compiles few shapes, pinning padded poses with an identity diagonal and
masking padded edges. Eager PyTorch has no compile to save, so the port solves
at the exact sizes. The answer is the same: a padded pose is a decoupled
identity block with a zero gradient (its step is zero), a masked edge adds
nothing, and the Levenberg floor takes max(max|diag H|, 1), which a pinned
pose's identity diagonal already reaches (tests/test_torch_graph_gn.py holds
the exact solve to JAX's padded one).

With a mesh (`parallel.make_mesh`), the solve shards its edges over the dp
ranks (`gauss_newton_graph(mesh=)`), the two-way edges padded with masked
ones to a multiple of dp.

Three solves: `solve_GN_rays`, `solve_GN_points` (scale-invariant 3D
points) and `solve_GN_calib`, which puts the keyframes' points on their pixel
rays through the intrinsics `K` before the pixel + log-depth solve (the
arena keeps its points as they are) and raises without `K`.
"""

from __future__ import annotations

import numpy as np
import torch

from mast3r_slam_torch.config import get_config
from mast3r_slam_torch.frame import Keyframes
from mast3r_slam_torch.geometry import constrain_points_to_ray
from mast3r_slam_torch.inference import mast3r_match_symmetric
from mast3r_slam_torch.ops.gauss_newton import GNParams, gauss_newton_graph
from mast3r_slam_torch.parallel.mesh import axis_size


class FactorGraph:
    def __init__(self, model, frames: Keyframes, K=None, mesh=None):
        """With `mesh` (a `DeviceMesh` with a "dp" axis), the graph solve
        shards its edge axis over the dp ranks (`gauss_newton_graph`), the
        two-way edge count padded with masked edges to a multiple of dp."""
        self.model = model
        self.frames = frames
        self.K = K  # [3, 3] intrinsics of the calibrated solve
        self.mesh = mesh
        self.cfg = get_config().local_opt
        self.device = frames.device
        n = frames.h * frames.w
        cap = self.cfg.max_edges
        self.capacity = cap
        self.n_points = n
        self.ii = np.zeros(cap, np.int64)
        self.jj = np.zeros(cap, np.int64)
        self.n_edges = 0
        self.n_decodes = 0  # symmetric decodes run by add_factors
        kw = dict(device=self.device)
        self.idx_ii2jj = torch.zeros((cap, n), dtype=torch.int64, **kw)
        self.idx_jj2ii = torch.zeros((cap, n), dtype=torch.int64, **kw)
        self.valid_match_j = torch.zeros((cap, n), dtype=torch.bool, **kw)
        self.valid_match_i = torch.zeros((cap, n), dtype=torch.bool, **kw)
        self.Q_ii2jj = torch.zeros((cap, n), dtype=torch.float32, **kw)
        self.Q_jj2ii = torch.zeros((cap, n), dtype=torch.float32, **kw)

    def _edge_buffers(self):
        return (self.idx_ii2jj, self.idx_jj2ii, self.valid_match_j, self.valid_match_i,
                self.Q_ii2jj, self.Q_jj2ii)

    # ---------------------------------------------------------------- prune

    def _compact_edges(self, keep: np.ndarray) -> int:
        """Keep the edge slots `keep` (ascending, within the live prefix);
        returns the number of edges removed."""
        removed = self.n_edges - keep.size
        if removed == 0:
            return 0
        kidx = torch.as_tensor(keep, device=self.device)
        for buf in self._edge_buffers():
            buf[: keep.size] = buf[kidx]  # advanced indexing copies the source first
        self.ii[: keep.size] = self.ii[keep]
        self.jj[: keep.size] = self.jj[keep]
        self.n_edges = keep.size
        return removed

    def prune_to_window(self, latest_kf: int, window_size: int | None = None) -> int:
        """Drop edges whose endpoints both fall before the window of the most
        recent `local_opt.window_size` keyframes; returns edges removed."""
        window_size = window_size if window_size is not None else self.cfg.window_size
        lo = latest_kf - window_size + 1
        if lo <= 0 or self.n_edges == 0:
            return 0
        e = self.n_edges
        keep = np.where((self.ii[:e] >= lo) | (self.jj[:e] >= lo))[0]
        return self._compact_edges(keep)

    def edge_degree(self, n_keyframes: int) -> np.ndarray:
        """Per-keyframe edge count (covisibility degree) over live edges."""
        deg = np.zeros(n_keyframes, np.int64)
        e = self.n_edges
        np.add.at(deg, self.ii[:e], 1)
        np.add.at(deg, self.jj[:e], 1)
        return deg

    def remove_keyframe(self, idx: int) -> int:
        """Evict keyframe `idx`: drop its edges and shift higher keyframe
        indices down one (the compaction of `Keyframes.remove`)."""
        e = self.n_edges
        removed = self._compact_edges(np.where((self.ii[:e] != idx) & (self.jj[:e] != idx))[0])
        e = self.n_edges
        self.ii[:e] = np.where(self.ii[:e] > idx, self.ii[:e] - 1, self.ii[:e])
        self.jj[:e] = np.where(self.jj[:e] > idx, self.jj[:e] - 1, self.jj[:e])
        return removed

    # ------------------------------------------------------------------ add

    def add_factors(self, ii: list[int], jj: list[int], min_match_frac: float,
                    is_reloc: bool = False) -> bool:
        """Match keyframe pairs (ii[b], jj[b]) in one symmetric decode and
        append the edges that pass; with `is_reloc`, any failing pair fails
        the whole request."""
        if not ii:
            return False
        kf = self.frames
        dev = self.device
        feat_i = kf._feat[torch.as_tensor(ii, device=dev)]
        feat_j = kf._feat[torch.as_tensor(jj, device=dev)]
        pos = kf._pos[None].expand(len(ii), *kf._pos.shape)
        idx_i2j, idx_j2i, vj, vi, Qii, Qjj, Qji, Qij = mast3r_match_symmetric(
            self.model, feat_i, pos, feat_j, pos)
        self.n_decodes += 1

        # Combined bidirectional confidences.
        Qj = torch.sqrt(torch.gather(Qii, 1, idx_i2j[..., None]) * Qji)
        Qi = torch.sqrt(torch.gather(Qjj, 1, idx_j2i[..., None]) * Qij)
        valid_j = vj & (Qj > self.cfg.Q_conf)
        valid_i = vi & (Qi > self.cfg.Q_conf)
        frac = torch.minimum(valid_j.float().mean(dim=(1, 2)), valid_i.float().mean(dim=(1, 2)))
        frac = frac.cpu().numpy()  # the one host read
        ii_np, jj_np = np.asarray(ii), np.asarray(jj)
        invalid = (ii_np != jj_np - 1) & (frac < min_match_frac)
        if is_reloc and invalid.any():
            return False
        keep = np.where(~invalid)[0]
        if keep.size == 0:
            return False
        if self.n_edges + keep.size > self.capacity:
            self.prune_to_window(int(max(ii_np.max(), jj_np.max())))
        space = self.capacity - self.n_edges
        if keep.size > space:
            print("[factor-graph] edge arena full; dropping edges")
            keep = keep[:space]
        if keep.size == 0:
            return False

        e0, e1 = self.n_edges, self.n_edges + keep.size
        sel = torch.as_tensor(keep, device=dev)
        self.ii[e0:e1] = ii_np[keep]
        self.jj[e0:e1] = jj_np[keep]
        for buf, src in zip(self._edge_buffers(),
                            (idx_i2j, idx_j2i, vj[..., 0], vi[..., 0], Qj[..., 0], Qi[..., 0])):
            buf[e0:e1] = src[sel]
        self.n_edges = e1
        return True

    # ---------------------------------------------------------------- solve

    def get_unique_kf_idx(self) -> np.ndarray:
        e = self.n_edges
        return np.unique(np.concatenate([self.ii[:e], self.jj[:e]]))

    def _prepare_solve(self):
        """Both directions of every edge in local keyframe indices, and the
        keyframe subset; None when there is nothing to move."""
        e = self.n_edges
        if e == 0:
            return None
        unique = self.get_unique_kf_idx()
        pin = self.cfg.pin
        if unique.size <= pin:
            return None
        to_local = np.full(int(unique.max()) + 1, -1, np.int64)
        to_local[unique] = np.arange(unique.size)
        dev = self.device
        ii2 = to_local[np.concatenate([self.ii[:e], self.jj[:e]])]
        jj2 = to_local[np.concatenate([self.jj[:e], self.ii[:e]])]
        sel = torch.as_tensor(unique, device=dev)
        frames = self.frames
        free = torch.zeros(unique.size, dtype=torch.bool, device=dev)
        free[pin:] = True
        # Under a mesh the edge axis shards over dp: pad it with masked edges
        # (JAX rounds its bucket up to a multiple of dp the same way).
        dp = axis_size(self.mesh, "dp")
        pad = -(2 * e) % dp
        n = self.n_points
        return dict(
            unique=unique,
            pin=pin,
            Twc=frames.T_WC[sel],
            Xs=frames.X[sel],
            Cs=(frames.C[sel] / torch.clamp(frames.N[sel], min=1.0))[..., 0],
            ii=torch.as_tensor(np.pad(ii2, (0, pad)), device=dev),
            jj=torch.as_tensor(np.pad(jj2, (0, pad)), device=dev),
            idx=torch.cat([self.idx_ii2jj[:e], self.idx_jj2ii[:e],
                           self.idx_ii2jj.new_zeros(pad, n)]),
            valid=torch.cat([self.valid_match_j[:e], self.valid_match_i[:e],
                             self.valid_match_j.new_zeros(pad, n)]),
            Q=torch.cat([self.Q_ii2jj[:e], self.Q_jj2ii[:e], self.Q_ii2jj.new_zeros(pad, n)]),
            edge_mask=torch.arange(2 * e + pad, device=dev) < 2 * e,
            free_mask=free,
        )

    def _params(self) -> GNParams:
        c = self.cfg
        return GNParams(
            sigma_ray=c.sigma_ray, sigma_dist=c.sigma_dist, sigma_pixel=c.sigma_pixel,
            sigma_depth=c.sigma_depth, C_thresh=c.C_conf, Q_thresh=c.Q_conf, huber_k=c.huber,
            robust=c.robust, tukey_t=c.tukey_t, max_iter=c.max_iters, delta_thresh=c.delta_norm,
            pixel_border=c.pixel_border, z_eps=c.depth_eps,
        )

    @torch.no_grad()
    def _solve(self, mode: str) -> None:
        prep = self._prepare_solve()
        if prep is None:
            return
        img_size = (self.frames.h, self.frames.w)
        Xs = prep["Xs"]
        if mode == "calib":
            if self.K is None:
                raise ValueError("Intrinsics K required for calibrated mode")
            Xs = constrain_points_to_ray(img_size, Xs, self.K)
        Twc_new, _ = gauss_newton_graph(
            prep["Twc"], Xs, prep["Cs"], prep["ii"], prep["jj"], prep["idx"],
            prep["valid"], prep["Q"], prep["edge_mask"], prep["free_mask"], mode=mode,
            K_intr=self.K if mode == "calib" else None, img_size=img_size,
            params=self._params(), variant=self.cfg.solve_variant,
            point_stride=self.cfg.point_stride, mesh=self.mesh,
        )
        unique, pin = prep["unique"], prep["pin"]
        self.frames.update_T_WCs(Twc_new[pin:], unique[pin:])

    def solve_GN_rays(self) -> None:
        self._solve("rays")

    def solve_GN_points(self) -> None:
        self._solve("points")

    def solve_GN_calib(self) -> None:
        self._solve("calib")
