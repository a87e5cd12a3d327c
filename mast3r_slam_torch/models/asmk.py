"""ASMK (Aggregated Selective Match Kernel) retrieval (the port of
``mast3r_slam_tpu/models/asmk.py``).

Local features are projected and PCA-whitened to d dims and assigned to the
nearest of W visual words; per word the residuals are summed, L2-normalised
and binarised (sign, 0 -> +1), so an image is B [W, d] in {-1, +1} (0 where a
word is absent) and a presence mask [W]. The similarity of a query to every
database row is the sum over co-present words of sign(u)|u|^alpha where the
cosine u of the two binary vectors exceeds tau, over sqrt(|words_q| *
|words_db|): one masked product over the whole [capacity, W, d] int8 arena.

Everything runs on the features' device, the whitening's `eigh` included.
Eigenvectors are defined up to sign: a flipped whitened coordinate flips the
same coordinate of every centroid, B and query, which leaves every score as
it is, though B itself differs.

The k-means initialisation draws `n_words` rows with `kmeans_init_indices`
(a seeded `torch.Generator`); JAX draws other numbers from its own seed, so
the parity tests hand JAX's draw to the port through that one function.
"""

from __future__ import annotations

import numpy as np
import torch

from mast3r_slam_torch.frame import _arena_remove
from mast3r_slam_torch.models.retrieval import pca_whitening


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)


def kmeans_init_indices(n: int, n_words: int, seed: int, device) -> torch.Tensor:
    """The rows of n features that seed `n_words` centroids: distinct rows
    when n >= n_words, else drawn with replacement."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if n < n_words:
        return torch.randint(n, (n_words,), generator=gen, device=device)
    return torch.randperm(n, generator=gen, device=device)[:n_words]


def _assign(f: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """[N, W] one-hot of each unit feature's most similar word (the first
    one on a tie, as `jnp.argmax`)."""
    assign = torch.argmax(f @ codebook.T, dim=-1)
    return torch.nn.functional.one_hot(assign, codebook.shape[0]).to(f.dtype)


def kmeans_codebook(feats: torch.Tensor, n_words: int, iters: int = 10,
                    seed: int = 0) -> torch.Tensor:
    """Spherical k-means on L2-normalised features [N, d] -> [W, d]; a word
    that gets no feature keeps its centroid."""
    feats = _l2_normalize(feats)
    c = feats[kmeans_init_indices(feats.shape[0], n_words, seed, feats.device)]
    for _ in range(iters):
        one_hot = _assign(feats, c)
        sums = one_hot.T @ feats
        counts = one_hot.sum(dim=0)[:, None]
        c = torch.where(counts > 0, _l2_normalize(sums), c)
    return c


def aggregate_binarize(feats: torch.Tensor, codebook: torch.Tensor):
    """One image's projected features [N, d] -> (B [W, d] int8, present [W])."""
    f = _l2_normalize(feats)
    one_hot = _assign(f, codebook)
    counts = one_hot.sum(dim=0)
    agg = one_hot.T @ f - counts[:, None] * codebook  # residuals summed per word
    present = counts > 0
    unit = _l2_normalize(agg)
    B = torch.where(present[:, None], torch.sign(unit) + (unit == 0).to(unit.dtype), 0.0)
    return B.to(torch.int8), present


def asmk_similarity(Bq: torch.Tensor, present_q: torch.Tensor, Bdb: torch.Tensor,
                    present_db: torch.Tensor, db_count: int, alpha: float = 3.0,
                    tau: float = 0.0) -> torch.Tensor:
    """Scores [K] of a query (Bq [W, d] int8, present_q [W]) against the arena
    (Bdb [K, W, d], present_db [K, W]); rows at or past `db_count` are -inf."""
    d = Bq.shape[-1]
    co = present_q[None, :] & present_db
    cos = torch.einsum("kwd,wd->kw", Bdb.float(), Bq.float()) / d
    sel = torch.where((cos > tau) & co, torch.sign(cos) * cos.abs() ** alpha, 0.0)
    raw = sel.sum(dim=-1)
    norm = torch.sqrt((present_q.sum() * present_db.sum(dim=-1)).float())
    scores = raw / torch.clamp(norm, min=1.0)
    rows = torch.arange(Bdb.shape[0], device=Bdb.device)
    return torch.where(rows < db_count, scores, -torch.inf)


class ASMKRetriever:
    """A keyframe-scale ASMK database on `device` (B [capacity, W, d] int8
    and present [capacity, W] bool)."""

    def __init__(self, feat_dim: int, n_words: int = 256, proj_dim: int = 64,
                 capacity: int = 512, seed: int = 0, device=None):
        self.n_words = n_words
        self.proj_dim = proj_dim
        self.capacity = capacity
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        # Until the first fit: a random orthogonal projection, the numbers of
        # the JAX package (numpy's generator and QR). fit_codebook replaces it
        # with the PCA whitening of the accumulated keyframe features.
        rng = np.random.default_rng(seed)
        q, _ = np.linalg.qr(rng.normal(size=(feat_dim, max(proj_dim, 1))))
        self.projection = torch.tensor(q[:, :proj_dim], dtype=torch.float32, device=self.device)
        self.mu = torch.zeros(feat_dim, dtype=torch.float32, device=self.device)
        self.codebook: torch.Tensor | None = None
        self.B = torch.zeros((capacity, n_words, proj_dim), dtype=torch.int8, device=self.device)
        self.present = torch.zeros((capacity, n_words), dtype=torch.bool, device=self.device)
        self.count = 0

    def _project(self, feats: torch.Tensor) -> torch.Tensor:
        return (feats.float() - self.mu) @ self.projection

    def fit_codebook(self, feats_list: list[torch.Tensor], iters: int = 10) -> None:
        """Learn the whitening from the features [N_i, D] of `feats_list`,
        then the visual words in the whitened space."""
        self.mu, self.projection = pca_whitening(torch.cat([f.float() for f in feats_list]),
                                                 self.proj_dim)
        f = torch.cat([self._project(f) for f in feats_list])
        self.codebook = kmeans_codebook(f, self.n_words, iters=iters)

    def ready(self) -> bool:
        return self.codebook is not None

    def refit(self, feats_list: list[torch.Tensor], iters: int = 10) -> None:
        """Re-learn whitening and words from the current map's features and
        re-aggregate every entry from them."""
        self.fit_codebook(feats_list, iters=iters)
        self.count = 0
        self.B.zero_()
        self.present.zero_()
        for f in feats_list:
            self.add(f)

    def add(self, feats: torch.Tensor) -> int:
        """Add one image's local features [N, D]; returns its row."""
        assert self.codebook is not None, "fit_codebook first"
        B, present = aggregate_binarize(self._project(feats), self.codebook)
        idx = self.count
        self.B[idx] = B
        self.present[idx] = present
        self.count += 1
        return idx

    def remove(self, idx: int) -> None:
        """Evict row `idx`; the rows above it move down one (the keyframe
        arena's compaction)."""
        if not 0 <= idx < self.count:
            return
        _arena_remove(self.B, idx)
        _arena_remove(self.present, idx)
        self.count -= 1

    def query(self, feats: torch.Tensor, k: int = 3) -> tuple[list[int], list[float]]:
        """The top-k rows and their scores, ties to the lower row, in one
        host read."""
        if self.count == 0 or self.codebook is None:
            return [], []
        Bq, pq = aggregate_binarize(self._project(feats), self.codebook)
        scores = asmk_similarity(Bq, pq, self.B, self.present, self.count)
        vals, idx = torch.sort(scores, descending=True, stable=True)
        k_eff = min(k, self.count)
        # one host read for both (rows < capacity are exact in f32)
        vals, idx = torch.stack([vals[:k_eff], idx[:k_eff].float()]).cpu().tolist()
        return [int(i) for i in idx], vals
