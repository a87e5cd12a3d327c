"""Retrieval head: whitened, attention-weighted global signatures (the port of
``mast3r_slam_tpu/models/retrieval.py``).

`forward_features(feat) -> (whitened, attention)` and
`forward_global(feat) -> signature` over backbone tokens [..., N, D]:
an affine whitening (identity at init), a positive per-token attention
weight (softplus of a linear map), the attention-weighted mean, an affine
post-whitening (identity at init) and L2 normalisation. The weights are a
dict in the flax layout ({layer: {"kernel" [in, out], "bias" [out]}}), so the
tests can hand the JAX head's weights over unchanged.
"""

from __future__ import annotations

import torch

from mast3r_slam_torch.device import resolve_device


def pca_whitening(feats: torch.Tensor, proj_dim: int, eps: float = 1e-6):
    """(mu [D], W [D, proj_dim]) such that (f - mu) @ W has identity
    covariance over the top `proj_dim` principal components (the port of
    ``pca_whitening`` in ``mast3r_slam_tpu/models/asmk.py``). Eigenvectors
    are defined up to sign."""
    m = feats.shape[0]
    mu = feats.mean(dim=0)
    x = feats - mu
    cov = (x.T @ x) / max(m - 1, 1)
    eigvals, eigvecs = torch.linalg.eigh(cov)  # ascending
    top = eigvecs[:, -proj_dim:].flip(-1)
    lam = eigvals[-proj_dim:].flip(-1)
    return mu, top / torch.sqrt(torch.clamp(lam, min=eps))[None, :]


class RetrievalModel:
    """The retrieval head on `device` (default: the card)."""

    def __init__(self, backbone_dim: int = 1024, out_dim: int | None = None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        out_dim = out_dim or backbone_dim
        self.out_dim = out_dim
        gen = torch.Generator(device=self.device).manual_seed(seed)
        kw = dict(dtype=torch.float32, device=self.device)
        eye = torch.eye(backbone_dim, out_dim, **kw)
        self.params = {
            "whiten": {"kernel": eye, "bias": torch.zeros(out_dim, **kw)},
            # lecun-normal scale, as the flax default; torch draws other numbers
            "attention": {"kernel": torch.randn(out_dim, 1, generator=gen, **kw) / out_dim**0.5,
                          "bias": torch.zeros(1, **kw)},
            "postwhiten": {"kernel": torch.eye(out_dim, **kw), "bias": torch.zeros(out_dim, **kw)},
        }

    @classmethod
    def from_pretrained(cls, backbone_dim: int = 1024, checkpoint: str | None = None,
                        device=None) -> "RetrievalModel":
        """The head; with `checkpoint`, its weights from a naver retrieval
        file (prewhiten / projector / attention / postwhiten, folded by
        `models.io.import_retrieval_state_dict`) or from a state dict in the
        head's own names (`models.io.import_retrieval_params`, strict)."""
        model = cls(backbone_dim, device=device)
        if checkpoint:
            from mast3r_slam_torch.models import io

            state = io.load_state_dict_file(checkpoint)
            if io.is_retrieval_state_dict(state):
                model.params = io.import_retrieval_state_dict(model.params, state)
            else:
                model.params = io.import_retrieval_params(model.params, state)
        return model

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        p = self.params[name]
        return x @ p["kernel"] + p["bias"]

    def _apply(self, feat: torch.Tensor):
        w = self._dense("whiten", feat)
        att = torch.nn.functional.softplus(self._dense("attention", w)) + 1e-6
        sig = (w * att).sum(dim=-2) / att.sum(dim=-2)
        sig = self._dense("postwhiten", sig)
        sig = sig / torch.clamp(torch.linalg.vector_norm(sig, dim=-1, keepdim=True), min=1e-8)
        return w, att, sig

    @torch.no_grad()
    def forward_features(self, feat: torch.Tensor):
        w, att, _ = self._apply(feat)
        return w, att

    @torch.no_grad()
    def forward_global(self, feat: torch.Tensor) -> torch.Tensor:
        return self._apply(feat)[2]

    @torch.no_grad()
    def fit_whitening(self, feats: torch.Tensor) -> None:
        """PCA-whitening learned from accumulated token features [M, D] of
        the first keyframes (the online substitute for pretrained
        whitening)."""
        mu, W = pca_whitening(feats.float(), self.out_dim)
        self.params["whiten"] = {"kernel": W, "bias": -(mu @ W)}
