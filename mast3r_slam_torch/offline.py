"""Offline multi-view reconstruction, with no temporal order assumed (the port
of ``mast3r_slam_tpu/offline.py``).

Given a set of frames: encode each and take its self-pair pointmap, build a
retrieval pair graph from the encoder signatures, match all pairs through
the decoder in batches into a factor graph, chain pairwise pose estimates
for the initialisation, then run the global graph Gauss-Newton.

    rec = OfflineReconstructor(model)
    result = rec.reconstruct(frames)
    # poses [F, 8], points [F, N, 3], confidences [F, N, 1], pairs, n_edges

Device work per call, for F frames and P pairs: F encodes and F mono
decodes; ceil(P / pair_batch) symmetric decodes of 2 * pair_batch pairs
(`FactorGraph.add_factors`); ceil((F - 1) / pair_batch) decodes of up to
pair_batch consecutive pairs with one batched pose solve each
(`_chain_initialize`); one graph solve.
"""

from __future__ import annotations

import torch

from mast3r_slam_torch.config import get_config
from mast3r_slam_torch.frame import Frame, Keyframes
from mast3r_slam_torch.geometry import point_to_ray_dist
from mast3r_slam_torch.global_opt import FactorGraph
from mast3r_slam_torch.inference import _ensure_encoded, _flatten_out, mast3r_inference_mono
from mast3r_slam_torch.lie import core as lie
from mast3r_slam_torch.matching import match
from mast3r_slam_torch.ops.gauss_newton import GNParams, gauss_newton_pose_rays
from mast3r_slam_torch.retrieval_db import select_pairs_from_retrieval


class OfflineReconstructor:
    def __init__(self, model, pair_k: int = 3, pair_batch: int = 8):
        self.model = model
        self.pair_k = pair_k
        self.pair_batch = pair_batch
        self.cfg = get_config()

    @torch.no_grad()
    def reconstruct(self, frames: list[Frame]) -> dict:
        n_frames = len(frames)
        if n_frames < 2:
            raise ValueError(f"offline reconstruction needs at least 2 frames, got {n_frames}")

        # 1. Encoder features and the self-pair pointmap of every frame.
        for f in frames:
            _ensure_encoded(self.model, f)
            if f.X_canon is None:
                X, C, _, _ = mast3r_inference_mono(self.model, f)
                f.X_canon, f.C, f.N, f.N_updates = X, C, 1, 1

        # The arena holds the pointmap grid: the image grid over img_downsample.
        f0 = max(1, self.cfg.dataset.img_downsample)
        h, w = frames[0].img.shape[:2]
        kfs = Keyframes(h // f0, w // f0, capacity=max(n_frames, 2), device=self.model.device)
        for f in frames:
            kfs.append(f)

        # 2. The pair graph from the mean-pooled, normalised encoder tokens
        # (in f32 whatever the model dtype).
        means = torch.stack([f.feat.float().mean(dim=0) for f in frames])
        sigs = means / torch.linalg.vector_norm(means, dim=-1, keepdim=True)
        pairs = select_pairs_from_retrieval(sigs, k=self.pair_k, min_thresh=-1.0,
                                            include_consecutive=True)

        # 3. Symmetric matching of the pairs, pair_batch at a time.
        graph = FactorGraph(self.model, kfs)
        for s in range(0, len(pairs), self.pair_batch):
            chunk = pairs[s:s + self.pair_batch]
            graph.add_factors([p[0] for p in chunk], [p[1] for p in chunk],
                              min_match_frac=self.cfg.local_opt.min_match_frac)

        # 4. Initialisation along the chain of consecutive frames.
        self._chain_initialize(kfs, frames)

        # 5. Global refinement.
        graph.solve_GN_rays()
        return dict(
            poses=kfs.get_poses().cpu().numpy(),
            points=kfs.get_points().cpu().numpy(),
            confidences=kfs.get_confidences().cpu().numpy(),
            pairs=pairs,
            n_edges=graph.n_edges,
        )

    def _chain_initialize(self, kfs: Keyframes, frames: list[Frame]) -> None:
        """T_W,i+1 = T_W,i * T_i,i+1, with T_i,i+1 from the two-view pose solve
        of frame i+1 against frame i: pair_batch consecutive pairs per decoder
        batch, their pose solves batched on the leading dimension."""
        t = self.cfg.tracking
        params = GNParams(sigma_ray=t.sigma_ray, sigma_dist=t.sigma_dist, huber_k=t.huber,
                          robust=t.robust, tukey_t=t.tukey_t, max_iter=t.max_iters,
                          delta_thresh=t.delta_norm)
        F = len(frames)
        T_rels = []
        for s in range(0, F - 1, self.pair_batch):
            idxs = list(range(s, min(s + self.pair_batch, F - 1)))
            f1 = torch.stack([frames[i + 1].feat for i in idxs])
            p1 = torch.stack([frames[i + 1].pos for i in idxs])
            f2 = torch.stack([frames[i].feat for i in idxs])
            p2 = torch.stack([frames[i].pos for i in idxs])
            out_f, out_k = self.model.decode(f1, p1, f2, p2)
            X, _C, D, Q = _flatten_out(out_f)
            Xk, _Ck, Dk, Qk = _flatten_out(out_k)
            idx, valid = match(X, Xk, D, Dk)  # [B, N], [B, N, 1]
            B = len(idxs)
            n = X.shape[1] * X.shape[2]
            g = idx.long()[..., None]
            Qc = torch.sqrt(torch.gather(Q.reshape(B, n, 1), 1, g) * Qk.reshape(B, n, 1))
            gate = (valid & (Qc > t.Q_conf)).float()
            Xf_g = torch.gather(X.reshape(B, n, 3), 1, g.expand(-1, -1, 3))
            rd_k = point_to_ray_dist(torch.stack([frames[i].X_canon for i in idxs]))
            wgt = gate * torch.sqrt(Qc)
            sqrt_info = torch.cat([(wgt / t.sigma_ray).expand(B, n, 3), wgt / t.sigma_dist], -1)
            T0 = lie.sim3_identity((B,), device=X.device)
            T_rel, _ = gauss_newton_pose_rays(T0, Xf_g, rd_k, sqrt_info, params)
            T_rels.append(T_rel)
        Ts = _chain_compose(kfs.T_WC[0], torch.cat(T_rels))
        kfs.update_T_WCs(Ts[1:], list(range(1, F)))


def _chain_compose(T0: torch.Tensor, T_rels: torch.Tensor) -> torch.Tensor:
    """Prefix-compose relative poses [F-1, 8] -> world poses [F, 8], row 0 = T0
    and row i+1 = row i * T_rels[i]."""
    Ts = [T0]
    for T_rel in T_rels:
        Ts.append(lie.sim3_mul(Ts[-1], T_rel))
    return torch.stack(Ts)
