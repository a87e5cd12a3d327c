"""Loop-closure retrieval database (the port of
``mast3r_slam_tpu/retrieval_db.py``).

Signatures live in a preallocated [capacity, D] matrix on the device; a query
is one masked matrix-vector product and a top-k, read back in one host
transfer. ``lax.top_k`` breaks ties toward the lower index; ``torch.topk`` on
the card promises no order among ties, so the port takes the first k of a
stable descending sort, which breaks them the same way.

With a 1024-wide backbone the learned `RetrievalModel` head makes the
signature, else the mean-pooled, L2-normalised tokens do ("simple
retrieval"). As in the JAX package, a head that fails to build quietly
selects simple retrieval: that is the system's retrieval policy, not a
fallback from the card, and it computes on the same device either way.

``retrieval.method: asmk`` adds an ASMK database (`models.asmk`) on the same
device: the first `retrieval.asmk_codebook_kf` keyframes' tokens are held
until the codebook is fitted on them, and until then queries take the
signature path; once the database holds twice as many entries as at the
last fit, the codebook is refitted from the tokens of the keyframe arena
(`keyframes`, wired by the SLAM loop).

`select_pairs_from_retrieval` builds the pair graph of offline
reconstruction (`offline`) from a set of signatures.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mast3r_slam_torch.config import get_config
from mast3r_slam_torch.frame import Frame, _arena_remove
from mast3r_slam_torch.models.asmk import ASMKRetriever
from mast3r_slam_torch.models.retrieval import RetrievalModel


def _topk_scores(signatures: torch.Tensor, count: int, query: torch.Tensor, k: int):
    """Masked dot-product top-k over the signature arena -> (scores, idx);
    ties go to the lower index."""
    scores = signatures @ query
    scores = torch.where(torch.arange(scores.shape[0], device=scores.device) < count,
                         scores, -torch.inf)
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return vals[:k], idx[:k]


def _mean_pool_signature(feat: torch.Tensor) -> torch.Tensor:
    sig = feat.mean(dim=0)
    return sig / torch.clamp(torch.linalg.vector_norm(sig), min=1e-8)


class RetrievalDatabase:
    """Global-signature retrieval, with the optional learned head and its
    online whitening (`retrieval.whitening_kf`), and ASMK with
    `retrieval.method: asmk`."""

    def __init__(self, model, backbone_dim: int = 1024, capacity: int | None = None,
                 device=None):
        cfg = get_config()
        rcfg = cfg.retrieval
        self.model = model
        self.device = torch.device(device) if device is not None else model.device
        self.backbone_dim = backbone_dim
        self.capacity = capacity or cfg.runtime.keyframe_capacity
        self.use_simple = backbone_dim != 1024
        self.retrieval: Optional[RetrievalModel] = None
        if not self.use_simple:
            try:
                self.retrieval = RetrievalModel.from_pretrained(backbone_dim, device=self.device)
            except Exception:  # noqa: BLE001 — the JAX policy: simple retrieval
                self.use_simple = True
        self.signatures = torch.zeros((self.capacity, backbone_dim), dtype=torch.float32,
                                      device=self.device)
        self.kf_ids: list[int] = []
        self.method = rcfg.method
        self._whitening_kf = rcfg.whitening_kf
        self._sig_pending: list[torch.Tensor] = []
        self._whitening_fitted = False
        self.asmk: Optional[ASMKRetriever] = None
        self._asmk_pending: list[torch.Tensor] = []  # tokens awaiting the first fit
        self._asmk_codebook_kf = rcfg.asmk_codebook_kf
        self._asmk_fit_size = 0  # entries at the last (re)fit
        self.keyframes = None  # the SLAM loop's arena: the tokens of an ASMK refit
        if self.method == "asmk":
            self.asmk = ASMKRetriever(feat_dim=backbone_dim, n_words=rcfg.asmk_n_words,
                                      proj_dim=rcfg.asmk_proj_dim, capacity=self.capacity,
                                      device=self.device)

    @property
    def kf_counter(self) -> int:
        return len(self.kf_ids)

    def compute_signature(self, feat: torch.Tensor) -> torch.Tensor:
        if feat.dim() == 1:
            return feat / torch.clamp(torch.linalg.vector_norm(feat), min=1e-8)
        if self.use_simple or self.retrieval is None:
            return _mean_pool_signature(feat.float())
        return self.retrieval.forward_global(feat.float())

    def prep_features(self, feat: torch.Tensor) -> torch.Tensor:
        """The whitened local features of the retrieval model, or `feat`
        itself without one."""
        if self.retrieval is None:
            return feat
        return self.retrieval.forward_features(feat)[0]

    @torch.no_grad()
    def update(self, frame: Frame, add_after_query: bool = True, k: int = 3,
               min_thresh: float = 0.0) -> list[int]:
        """Query the top-k similar keyframes, then optionally insert the frame."""
        if frame.feat is None:
            from mast3r_slam_torch.inference import _ensure_encoded

            _ensure_encoded(self.model, frame)
        sig = self.compute_signature(frame.feat)
        topk: list[int] = []
        count = self.kf_counter
        if self.asmk is not None and self.asmk.ready() and self.asmk.count > 0:
            ids, scores = self.asmk.query(frame.feat, k=k)
            topk = [self.kf_ids[i] for i, s in zip(ids, scores) if s > min_thresh]
        elif count > 0:
            scores, idx = _topk_scores(self.signatures, count, sig, min(k, count))
            # one host read for both (indices < capacity are exact in f32)
            scores, idx = torch.stack([scores, idx.float()]).cpu().tolist()
            for s, i in zip(scores, idx):
                if s > min_thresh:
                    topk.append(self.kf_ids[int(i)])
        if add_after_query:
            assert count < self.capacity, "retrieval arena full"
            self.signatures[count] = sig
            self.kf_ids.append(count)
            if self.asmk is not None:
                self._asmk_add(frame.feat)
            self._maybe_fit_whitening(frame.feat)
        return topk

    def _maybe_fit_whitening(self, feat: torch.Tensor) -> None:
        """After `retrieval.whitening_kf` keyframes, fit the head's whitening
        on their tokens and recompute the stored signatures."""
        if (self._whitening_kf <= 0 or self._whitening_fitted or self.retrieval is None
                or feat is None):
            return
        self._sig_pending.append(feat)
        if len(self._sig_pending) < self._whitening_kf:
            return
        stacked = torch.cat([f.float().reshape(-1, f.shape[-1]) for f in self._sig_pending])
        self.retrieval.fit_whitening(stacked)
        self._whitening_fitted = True
        for i, f in enumerate(self._sig_pending):
            self.signatures[i] = self.compute_signature(f)
        self._sig_pending = []

    def remove(self, idx: int) -> None:
        """Evict keyframe `idx`'s signature and compact (higher indices move
        down one, as in the keyframe arena)."""
        if not 0 <= idx < self.kf_counter:
            return
        _arena_remove(self.signatures, idx)
        self.kf_ids.pop()  # kf_ids is the identity map [0, count)
        if self.asmk is not None:
            if self.asmk.ready():
                self.asmk.remove(idx)
            elif idx < len(self._asmk_pending):
                self._asmk_pending.pop(idx)
        if not self._whitening_fitted and idx < len(self._sig_pending):
            self._sig_pending.pop(idx)

    def _asmk_add(self, feat: torch.Tensor) -> None:
        """Insert into the ASMK database: hold the tokens until
        `asmk_codebook_kf` keyframes have come, then fit and add them all;
        after that add, and refit from the arena once the database has
        doubled since the last fit."""
        if not self.asmk.ready():
            self._asmk_pending.append(feat)
            if len(self._asmk_pending) >= self._asmk_codebook_kf:
                self.asmk.fit_codebook(self._asmk_pending)
                for f in self._asmk_pending:
                    self.asmk.add(f)
                self._asmk_fit_size = len(self._asmk_pending)
                self._asmk_pending = []
            return
        self.asmk.add(feat)
        count = self.asmk.count
        if (self.keyframes is not None and self.keyframes._feat is not None
                and count >= 2 * max(self._asmk_fit_size, 1) and count <= len(self.keyframes)):
            self.asmk.refit([self.keyframes._feat[i] for i in range(count)])
            self._asmk_fit_size = count

    @torch.no_grad()
    def query(self, feat: torch.Tensor, k: int = 3) -> tuple[list[int], list[float]]:
        if self.kf_counter == 0:
            return [], []
        sig = self.compute_signature(feat)
        scores, idx = _topk_scores(self.signatures, self.kf_counter, sig,
                                   min(k, self.kf_counter))
        return [self.kf_ids[i] for i in idx.cpu().tolist()], scores.cpu().tolist()


def load_retriever(model, backbone_dim: int | None = None) -> RetrievalDatabase:
    """The SLAM loop's database, on the model's device."""
    if backbone_dim is None:
        backbone_dim = getattr(model, "embed_dim", 1024)
    return RetrievalDatabase(model, backbone_dim=backbone_dim)


# ---------------------------------------------------------------------------
# Offline pair selection (the retrieval graph of `offline.OfflineReconstructor`)
# ---------------------------------------------------------------------------


def compute_similarity_matrix(signatures: torch.Tensor) -> torch.Tensor:
    """[N, D] signatures -> [N, N] cosine similarities, on their device."""
    sig = signatures / torch.clamp(torch.linalg.vector_norm(signatures, dim=-1, keepdim=True),
                                   min=1e-8)
    return sig @ sig.T


def select_pairs_from_retrieval(signatures: torch.Tensor, k: int = 3, min_thresh: float = 0.0,
                                include_consecutive: bool = True) -> list[tuple[int, int]]:
    """The k most similar images of each image, as pairs (i, j) with i < j
    above `min_thresh`, deduplicated, with the consecutive chain (i, i + 1)
    when `include_consecutive`; sorted. The similarities are read to the
    host once."""
    n = signatures.shape[0]
    sim = compute_similarity_matrix(signatures).cpu().numpy()
    sim[np.arange(n), np.arange(n)] = -np.inf
    pairs: set[tuple[int, int]] = set()
    if include_consecutive:
        pairs.update((i, i + 1) for i in range(n - 1))
    for i in range(n):
        for j in np.argsort(-sim[i])[:k]:
            if sim[i, j] > min_thresh:
                pairs.add((min(i, int(j)), max(i, int(j))))
    return sorted(pairs)
