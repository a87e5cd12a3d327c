"""The port's retrieval (models/retrieval.py, retrieval_db.py, the signature
path) against the JAX package's, on numpy-seeded encoder tokens.

Tolerances: retrieved keyframe lists exact; top-k ties in the same order
(lower index first); signatures and scores within 1e-5 (f32 sums in other
orders); the PCA whitening within 1e-4 after aligning the sign of each
eigenvector, which eigh defines only up to sign.
"""

import numpy as np
import pytest
import torch

from mast3r_slam_tpu import config as jax_config
from mast3r_slam_tpu import retrieval_db as jax_db
from mast3r_slam_tpu.frame import Frame as JaxFrame
from mast3r_slam_tpu.models.retrieval import RetrievalModel as JaxRetrievalModel
from mast3r_slam_torch import config as torch_config
from mast3r_slam_torch import retrieval_db
from mast3r_slam_torch.frame import Frame
from mast3r_slam_torch.models.retrieval import RetrievalModel


class _Model:
    device = torch.device("cpu")

    def __init__(self, dim):
        self.embed_dim = dim


def _tokens(rng, n, s, d):
    """n keyframes' tokens [s, d]: a shared component plus noise, so that
    similarities differ and rank."""
    base = rng.normal(size=(s, d))
    return [(base * rng.uniform(0.2, 1.0) + rng.normal(size=(s, d))).astype(np.float32)
            for _ in range(n)]


def _pair(feat, fid):
    img = np.zeros((2, 2, 3), np.float32)
    return (JaxFrame(frame_id=fid, img=img, feat=feat),
            Frame(frame_id=fid, img=torch.from_numpy(img), feat=torch.from_numpy(feat)))


def _head_params_from_jax(jm: JaxRetrievalModel) -> dict:
    return {name: {k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
            for name, layer in jm.params["params"].items()}


@pytest.fixture
def configs():
    def install(d):
        jax_config.set_config(jax_config.Config.from_dict(d))
        torch_config.set_config(torch_config.Config.from_dict(d))
    yield install
    torch_config.reset_config()


def test_topk_ties_break_toward_the_lower_index():
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(4, 8)).astype(np.float32)
    sigs = np.concatenate([rows, rows[::-1], rows, np.zeros((4, 8), np.float32)])  # ties
    q = rows[1].copy()
    for count, k in ((12, 6), (9, 9), (12, 12)):
        js, ji = jax_db._topk_scores(sigs, np.int32(count), q, k)
        ts, ti = retrieval_db._topk_scores(torch.from_numpy(sigs), count, torch.from_numpy(q), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dim", [16, 1024])
def test_database_update_query_remove_match_jax(configs, dim):
    """dim 16: simple retrieval (mean-pooled tokens); dim 1024: the learned
    head, with the JAX head's weights handed to the port."""
    configs({"runtime": {"keyframe_capacity": 8}, "retrieval": {"whitening_kf": 0}})
    rng = np.random.default_rng(dim)
    j = jax_db.load_retriever(_Model(dim))
    t = retrieval_db.load_retriever(_Model(dim))
    assert t.use_simple == j.use_simple == (dim != 1024)
    if dim == 1024:
        t.retrieval.params = _head_params_from_jax(j.retrieval)
    feats = _tokens(rng, 9, 6, dim)

    def check_state():
        assert t.kf_ids == j.kf_ids
        np.testing.assert_allclose(t.signatures.numpy(), np.asarray(j.signatures), atol=1e-5,
                                   rtol=0)

    for n, feat in enumerate(feats[:6]):
        jf, tf = _pair(feat, n)
        kw = dict(add_after_query=n != 3, k=3, min_thresh=0.1 if n % 2 else 0.0)
        assert t.update(tf, **kw) == j.update(jf, **kw)
        check_state()
    for idx in (2, 0, 99):
        j.remove(idx)
        t.remove(idx)
        check_state()
    for feat in feats[6:]:
        ti, ts = t.query(torch.from_numpy(feat), k=4)
        ji, js = j.query(feat, k=4)
        assert ti == ji
        np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)


def _align(W_port: torch.Tensor, W_jax) -> torch.Tensor:
    W_jax = torch.from_numpy(np.array(W_jax))
    return W_port * torch.sign((W_port * W_jax).sum(0, keepdim=True))


def test_head_and_whitening_match_jax():
    d = 16
    rng = np.random.default_rng(5)
    jm = JaxRetrievalModel(d)
    tm = RetrievalModel(d, device="cpu")
    tm.params = _head_params_from_jax(jm)
    feat = _tokens(rng, 1, 10, d)[0]
    w_t, att_t = tm.forward_features(torch.from_numpy(feat))
    w_j, att_j = jm.forward_features(feat)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(att_t.numpy(), np.asarray(att_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm.forward_global(torch.from_numpy(feat)).numpy(),
                               np.asarray(jm.forward_global(feat)), atol=1e-5, rtol=0)

    fit = np.concatenate(_tokens(rng, 4, 50, d))
    jm.fit_whitening(fit)
    tm.fit_whitening(torch.from_numpy(fit))
    W_j = jm.params["params"]["whiten"]["kernel"]
    W_t = _align(tm.params["whiten"]["kernel"], W_j)
    np.testing.assert_allclose(W_t.numpy(), np.asarray(W_j), atol=1e-4, rtol=0)
    white = (torch.from_numpy(fit) - torch.from_numpy(fit).mean(0)) @ tm.params["whiten"]["kernel"]
    np.testing.assert_allclose((white.T @ white / (len(fit) - 1)).numpy(), np.eye(d), atol=1e-3)
    tm.params["whiten"] = {"kernel": W_t, "bias": -(torch.from_numpy(fit).mean(0) @ W_t)}
    np.testing.assert_allclose(tm.forward_global(torch.from_numpy(feat)).numpy(),
                               np.asarray(jm.forward_global(feat)), atol=1e-4, rtol=0)


def test_online_whitening_recomputes_the_stored_signatures(configs):
    configs({"runtime": {"keyframe_capacity": 8}, "retrieval": {"whitening_kf": 3}})
    db = retrieval_db.load_retriever(_Model(1024))
    assert db.retrieval is not None and not db.use_simple
    feats = _tokens(np.random.default_rng(9), 4, 400, 1024)
    for n, feat in enumerate(feats):
        db.update(Frame(frame_id=n, img=torch.zeros(2, 2, 3), feat=torch.from_numpy(feat)))
        assert db._whitening_fitted == (n >= 2)
    assert db._sig_pending == []
    for n, feat in enumerate(feats):
        np.testing.assert_allclose(db.signatures[n].numpy(),
                                   db.compute_signature(torch.from_numpy(feat)).numpy(),
                                   atol=1e-6, rtol=0)
    ids, scores = db.query(torch.from_numpy(feats[2]), k=2)
    assert ids[0] == 2 and scores[0] == pytest.approx(1.0, abs=1e-5)


def test_asmk_and_checkpoints_raise(configs):
    """`retrieval.method: asmk` builds the ASMK database on the database's
    device (tests/test_torch_asmk.py holds it to JAX); only loading a
    retrieval checkpoint still raises."""
    configs({"retrieval": {"method": "asmk", "asmk_n_words": 16, "asmk_proj_dim": 8},
             "runtime": {"keyframe_capacity": 8}})
    db = retrieval_db.load_retriever(_Model(16))
    assert db.method == "asmk" and db.asmk is not None and not db.asmk.ready()
    assert db.asmk.B.shape == (8, 16, 8) and db.asmk.B.device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        RetrievalModel.from_pretrained(16, checkpoint="weights.pth", device="cpu")
