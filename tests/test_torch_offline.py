"""Offline reconstruction (`offline.OfflineReconstructor`) and the retrieval
pair selection (`retrieval_db.select_pairs_from_retrieval`) of the port
against the JAX package's.

The world is tests/test_offline.py's: tests/oracle.py's oracle two-view
model (6 frames of a 16x16 surface, steps of 0.05) behind the port's model
interface (tests/test_torch_slam.py `TorchOracle`), the simple matcher.
Bands: the pair graph and the edge count exact; poses within
test_offline's 5e-3 of the truth and of JAX's (pose_distance, the norm of
the relative Sim3 log). The pair selection is also held exact on random
signatures, and the chain initialisation to its decoder batches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.config import Config as JaxConfig
from mast3r_slam_tpu.config import set_config as jax_set_config
from mast3r_slam_tpu.frame import create_frame as jax_create_frame
from mast3r_slam_tpu.offline import OfflineReconstructor as JaxOfflineReconstructor
from mast3r_slam_tpu.offline import _chain_compose as jax_chain_compose
from mast3r_slam_tpu.retrieval_db import select_pairs_from_retrieval as jax_select_pairs
from mast3r_slam_torch import config as torch_config
from mast3r_slam_torch.frame import create_frame
from mast3r_slam_torch.offline import OfflineReconstructor, _chain_compose
from mast3r_slam_torch.retrieval_db import compute_similarity_matrix, select_pairs_from_retrieval
from test_torch_slam import TorchOracle
from tests.fixtures import pose_distance
from tests.oracle import make_oracle_world, render_frame_image

SETTINGS = {
    "runtime": {"keyframe_capacity": 8},
    "local_opt": {"max_edges": 32},
    "matching": {"use_simple": True, "dist_thresh": 0.5},
}
POSE_TOL = 5e-3


@pytest.mark.parametrize("k,min_thresh,consecutive", [(1, 0.5, True), (3, -1.0, True),
                                                       (2, 0.0, False)])
def test_select_pairs_matches_jax(k, min_thresh, consecutive):
    rng = np.random.default_rng(k)
    sigs = rng.normal(size=(9, 16)).astype(np.float32)
    sigs[4] = sigs[2] + 0.01  # a near duplicate
    want = jax_select_pairs(jnp.asarray(sigs), k=k, min_thresh=min_thresh,
                            include_consecutive=consecutive)
    got = select_pairs_from_retrieval(torch.from_numpy(sigs), k=k, min_thresh=min_thresh,
                                      include_consecutive=consecutive)
    assert got == want and (2, 4) in got
    np.testing.assert_allclose(compute_similarity_matrix(torch.from_numpy(sigs)).numpy(),
                               sigs @ sigs.T / np.outer(*[np.linalg.norm(sigs, axis=1)] * 2),
                               atol=1e-6)


def test_chain_compose_matches_jax():
    rng = np.random.default_rng(3)
    from mast3r_slam_tpu.lie import core as jlie

    T_rels = np.array(jlie.sim3_exp(jnp.asarray(rng.normal(size=(5, 7)).astype(np.float32)
                                                  * 0.3)))
    T0 = np.array(jlie.sim3_exp(jnp.asarray(rng.normal(size=7).astype(np.float32) * 0.3)))
    np.testing.assert_allclose(_chain_compose(torch.from_numpy(T0), torch.from_numpy(T_rels)),
                               np.asarray(jax_chain_compose(jnp.asarray(T0), jnp.asarray(T_rels))),
                               atol=1e-6)


def test_offline_reconstruction_matches_jax():
    h = w = 16
    n = 6
    rng = np.random.default_rng(42)
    model, gt = make_oracle_world(rng, n, h, w, step=0.05)
    imgs = [render_frame_image(i, h, w, rng) for i in range(n)]

    jax_set_config(JaxConfig.from_dict(SETTINGS))
    jout = JaxOfflineReconstructor(model, pair_k=2).reconstruct(
        [jax_create_frame(i, jnp.asarray(img)) for i, img in enumerate(imgs)])
    torch_config.set_config(torch_config.Config.from_dict(SETTINGS))
    try:
        oracle = TorchOracle(model)
        decodes = []
        decode = oracle.decode
        oracle.decode = lambda *a: (decodes.append(a[0].shape[0]) or decode(*a))
        out = OfflineReconstructor(oracle, pair_k=2, pair_batch=4).reconstruct(
            [create_frame(i, img) for i, img in enumerate(imgs)])
    finally:
        torch_config.reset_config()

    assert out["pairs"] == jout["pairs"] and len(out["pairs"]) >= n - 1
    assert out["n_edges"] == jout["n_edges"] > 0
    # symmetric decodes of 4 pairs (batch 8) for the graph, then the chain's
    # 5 consecutive pairs in batches of 4 and 1
    n_sym = -(-len(out["pairs"]) // 4)
    assert decodes[:n_sym] == [8] * (n_sym - 1) + [2 * (len(out["pairs"]) - 4 * (n_sym - 1))]
    assert decodes[n_sym:] == [4, 1]
    assert out["poses"].shape == (n, 8) and np.isfinite(out["poses"]).all()
    assert out["points"].shape == (n, h * w, 3) and out["confidences"].shape == (n, h * w, 1)
    for i in range(n):
        assert pose_distance(out["poses"][i], gt[i]) < POSE_TOL, i
        assert pose_distance(out["poses"][i], jout["poses"][i]) < POSE_TOL, i
