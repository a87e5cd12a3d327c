"""The port's ASMK retrieval (models/asmk.py and the ASMK path of
retrieval_db.py) against the JAX package's, on numpy-seeded features.

The k-means initial rows are drawn by `kmeans_init_indices` in the port and
by `jax.random.choice` in JAX, which draw different numbers from one seed,
so the port is handed JAX's draw (monkeypatched). PCA eigenvectors are
defined up to sign, so after a fit the scores and the retrieved rows are
compared, not B; the features have a separated spectrum, so no two top
eigenvalues are close enough for eigh to rotate their vectors.

Tolerances: the codebook within 1e-5 (f32 sums in other orders); B and the
presence mask bit for bit on the same codebook; similarity within 1e-6;
after a fit, scores within 1e-5 and the same top-k and retrieved keyframes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import config as jax_config
from mast3r_slam_tpu import retrieval_db as jax_db
from mast3r_slam_tpu.frame import Frame as JaxFrame
from mast3r_slam_tpu.models import asmk as jax_asmk
from mast3r_slam_torch import config as torch_config
from mast3r_slam_torch import retrieval_db
from mast3r_slam_torch.frame import Frame
from mast3r_slam_torch.models import asmk


def _jax_draw(n, n_words, seed, device):
    idx = jax.random.choice(jax.random.PRNGKey(seed), n, shape=(n_words,), replace=n < n_words)
    return torch.from_numpy(np.array(idx)).long().to(device)


@pytest.fixture
def jax_init(monkeypatch):
    monkeypatch.setattr(asmk, "kmeans_init_indices", _jax_draw)


def _spectrum_feats(rng, n, d, proj_dim):
    """n features [n, d] whose covariance has well separated leading
    eigenvalues (scales 4.0, 3.6, ... down the first proj_dim axes of a random
    rotation) and a flat tail."""
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    scales = np.concatenate([4.0 * 0.9 ** np.arange(proj_dim), np.full(d - proj_dim, 0.3)])
    return ((rng.normal(size=(n, d)) * scales) @ q.T + 0.5).astype(np.float32)


def _scenes(rng, n_scenes, n, d, proj_dim):
    base = _spectrum_feats(rng, n * n_scenes, d, proj_dim)
    return [base[i * n:(i + 1) * n] for i in range(n_scenes)]


@pytest.mark.parametrize("n,n_words", [(200, 8), (6, 8)])
def test_kmeans_codebook_matches_jax(jax_init, n, n_words):
    rng = np.random.default_rng(n)
    feats = rng.normal(size=(n, 8)).astype(np.float32)
    want = np.asarray(jax_asmk.kmeans_codebook(jnp.asarray(feats), n_words, iters=10))
    got = asmk.kmeans_codebook(torch.from_numpy(feats), n_words, iters=10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_kmeans_init_indices_draws_distinct_rows_unless_short():
    idx = asmk.kmeans_init_indices(50, 16, 0, "cpu")
    assert len(set(idx.tolist())) == 16 and int(idx.max()) < 50
    assert torch.equal(idx, asmk.kmeans_init_indices(50, 16, 0, "cpu"))
    short = asmk.kmeans_init_indices(5, 16, 0, "cpu")
    assert short.shape == (16,) and int(short.max()) < 5


def test_aggregate_binarize_matches_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    cb = rng.normal(size=(16, 8)).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    for n in (3, 30, 200):
        feats = rng.normal(size=(n, 8)).astype(np.float32)
        jB, jp = map(np.asarray, jax_asmk.aggregate_binarize(jnp.asarray(feats), jnp.asarray(cb)))
        tB, tp = asmk.aggregate_binarize(torch.from_numpy(feats), torch.from_numpy(cb))
        assert tB.dtype == torch.int8 and tp.dtype == torch.bool
        np.testing.assert_array_equal(tB.numpy(), jB)
        np.testing.assert_array_equal(tp.numpy(), jp)
    # a residual coordinate of exactly 0 binarises to +1, as jnp.sign + (u == 0)
    f = torch.tensor([[1.0, 0.0], [1.0, 0.0]])
    B, present = asmk.aggregate_binarize(f, torch.tensor([[1.0, 0.0], [0.0, 1.0]]))
    assert B.tolist() == [[1, 1], [0, 0]] and present.tolist() == [True, False]


def test_asmk_similarity_matches_jax():
    rng = np.random.default_rng(2)
    cb = rng.normal(size=(16, 8)).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    descs = [jax_asmk.aggregate_binarize(jnp.asarray(rng.normal(size=(m, 8)).astype(np.float32)),
                                         jnp.asarray(cb)) for m in (4, 10, 25, 40, 9, 12)]
    Bdb = np.stack([np.asarray(b) for b, _ in descs])
    Pdb = np.stack([np.asarray(p) for _, p in descs])
    for q in range(3):
        for count in (6, 4):
            for alpha, tau in ((3.0, 0.0), (1.0, -0.2)):
                want = np.asarray(jax_asmk.asmk_similarity(
                    descs[q][0], descs[q][1], jnp.asarray(Bdb), jnp.asarray(Pdb),
                    jnp.asarray(count), alpha=alpha, tau=tau))
                got = asmk.asmk_similarity(
                    torch.from_numpy(Bdb[q]), torch.from_numpy(Pdb[q]), torch.from_numpy(Bdb),
                    torch.from_numpy(Pdb), count, alpha=alpha, tau=tau)
                np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _fit_both(scenes, n_words, proj_dim):
    j = jax_asmk.ASMKRetriever(feat_dim=scenes[0].shape[1], n_words=n_words, proj_dim=proj_dim,
                               capacity=len(scenes) + 2)
    t = asmk.ASMKRetriever(feat_dim=scenes[0].shape[1], n_words=n_words, proj_dim=proj_dim,
                           capacity=len(scenes) + 2)
    np.testing.assert_array_equal(t.projection.numpy(), np.asarray(j.projection))
    j.fit_codebook([jnp.asarray(s) for s in scenes[:4]])
    t.fit_codebook([torch.from_numpy(s) for s in scenes[:4]])
    for s in scenes:
        assert t.add(torch.from_numpy(s)) == j.add(jnp.asarray(s))
    return j, t


def test_retriever_end_to_end_matches_jax(jax_init):
    rng = np.random.default_rng(3)
    scenes = _scenes(rng, 6, 60, 32, 8)
    j, t = _fit_both(scenes, n_words=8, proj_dim=8)
    assert t.ready() and t.count == j.count == 6
    for i in (2, 5, 0):
        q = scenes[i] + rng.normal(size=scenes[i].shape).astype(np.float32) * 0.05
        ti, ts = t.query(torch.from_numpy(q), k=4)
        ji, js = j.query(jnp.asarray(q), k=4)
        assert ti == ji and ti[0] == i
        np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
    for idx in (1, 0, 99):
        j.remove(idx)
        t.remove(idx)
    assert t.count == j.count == 4
    q = scenes[4] + rng.normal(size=scenes[4].shape).astype(np.float32) * 0.05
    ti, ts = t.query(torch.from_numpy(q), k=3)
    ji, js = j.query(jnp.asarray(q), k=3)
    assert ti == ji == [2, *ji[1:]]
    np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)


def test_sign_flips_of_whitened_coordinates_leave_scores_unchanged(jax_init):
    rng = np.random.default_rng(4)
    scenes = _scenes(rng, 5, 60, 32, 8)
    t = asmk.ASMKRetriever(feat_dim=32, n_words=8, proj_dim=8, capacity=8)
    t.fit_codebook([torch.from_numpy(s) for s in scenes])
    for s in scenes:
        t.add(torch.from_numpy(s))
    q = torch.from_numpy(scenes[3] + rng.normal(size=scenes[3].shape).astype(np.float32) * 0.05)
    ids, scores = t.query(q, k=5)

    flip = torch.tensor([1.0, -1, 1, 1, -1, -1, 1, -1])
    B0 = t.B.clone()
    t.projection, t.codebook = t.projection * flip, t.codebook * flip
    t.count = 0
    for s in scenes:
        t.add(torch.from_numpy(s))
    flipped = flip.to(torch.int8)[None, None] * B0
    assert torch.equal(t.B[:5], flipped[:5])  # B flips with the coordinates
    ids_f, scores_f = t.query(q, k=5)
    assert ids_f == ids and scores_f == scores  # the scores do not


class _Arena:
    """The keyframe arena as the retrieval database reads it: `_feat` rows
    and a length."""

    def __init__(self, feats):
        self._feat = feats

    def __len__(self):
        return len(self._feat)


def _pair(feat, fid):
    img = np.zeros((2, 2, 3), np.float32)
    return (JaxFrame(frame_id=fid, img=img, feat=jnp.asarray(feat)),
            Frame(frame_id=fid, img=torch.from_numpy(img), feat=torch.from_numpy(feat)))


class _Model:
    device = torch.device("cpu")
    embed_dim = 32


@pytest.mark.parametrize("wired", [True, False])
def test_database_fit_refit_and_remove_match_jax(jax_init, wired):
    """The codebook is fitted at the 3rd keyframe and, with the arena wired,
    refitted at the 6th (twice the fit size); an eviction before the fit drops
    the held tokens, one after it the ASMK row. Every query's retrieved
    keyframes equal JAX's."""
    settings = {"runtime": {"keyframe_capacity": 12},
                "retrieval": {"method": "asmk", "asmk_n_words": 8, "asmk_proj_dim": 8,
                              "asmk_codebook_kf": 3}}
    jax_config.set_config(jax_config.Config.from_dict(settings))
    torch_config.set_config(torch_config.Config.from_dict(settings))
    try:
        j = jax_db.load_retriever(_Model())
        t = retrieval_db.load_retriever(_Model())
    finally:
        torch_config.reset_config()
    rng = np.random.default_rng(5)
    scenes = _scenes(rng, 9, 40, 32, 8)
    live = []  # the arena's tokens, kept in step with the database

    def add(i, **kw):
        jf, tf = _pair(scenes[i], i)
        if kw.get("add_after_query", True):
            live.append(scenes[i])
            if wired:
                j.keyframes = _Arena([jnp.asarray(f) for f in live])
                t.keyframes = _Arena(torch.from_numpy(np.stack(live)))
        assert t.update(tf, **kw) == j.update(jf, **kw)

    def remove(idx):
        live.pop(idx)
        j.remove(idx)
        t.remove(idx)

    add(0)
    add(1)
    remove(0)  # before the fit: the held tokens of keyframe 0 go
    assert len(t._asmk_pending) == len(j._asmk_pending) == 1 and not t.asmk.ready()
    add(2, add_after_query=False, k=2, min_thresh=-1.0)  # signature path until the fit
    add(2)
    add(3)
    assert t.asmk.ready() and t._asmk_fit_size == j._asmk_fit_size == 3
    remove(1)  # after the fit: the ASMK row goes
    assert t.asmk.count == j.asmk.count == 2
    for i in (4, 5, 6, 7):
        add(i, k=3, min_thresh=-1.0)
    assert t._asmk_fit_size == j._asmk_fit_size == (6 if wired else 3)
    assert t.asmk.count == j.asmk.count == 6
    for i in (3, 6, 8):
        q = scenes[i] + rng.normal(size=scenes[i].shape).astype(np.float32) * 0.05
        jf, tf = _pair(q.astype(np.float32), 100 + i)
        assert t.update(tf, add_after_query=False, k=3, min_thresh=-1.0) == j.update(
            jf, add_after_query=False, k=3, min_thresh=-1.0)
        ti, ts = t.asmk.query(torch.from_numpy(q), k=6)
        ji, js = j.asmk.query(jnp.asarray(q), k=6)
        assert ti == ji
        np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
