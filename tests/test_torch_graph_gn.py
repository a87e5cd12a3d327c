"""The port's backend graph solve (ops.gauss_newton.gauss_newton_graph, rays
mode) and its FactorGraph against the JAX package's.

Problems come from tests/fixtures.py `make_graph_problem` (a world surface
seen by K keyframes with permuted pixels, numpy-seeded) with the poses
perturbed off the truth. Band: poses within 1e-5 (f32; the two solves sum
the same terms in other orders). The FactorGraph test runs the tiny model's
symmetric decode on both sides: edges and match masks exact, poses within
5e-4 (the band of test_torch_slice.py: the models' f32 outputs differ by
~1e-6 relative), after a rays solve and after a points-mode solve.
tests/test_torch_calib_ops.py holds the calib and points modes of the solve
itself.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.frame import Keyframes as JaxKeyframes
from mast3r_slam_tpu.frame import create_frame as jax_create_frame
from mast3r_slam_tpu.global_opt import FactorGraph as JaxFactorGraph
from mast3r_slam_tpu.global_opt import _bucket
from mast3r_slam_tpu.inference import mast3r_inference_mono as jax_mono
from mast3r_slam_tpu.ops.gauss_newton import GNParams as JaxGNParams
from mast3r_slam_tpu.ops.gauss_newton import gauss_newton_graph as jax_graph
from mast3r_slam_torch.frame import Keyframes, create_frame
from mast3r_slam_torch.global_opt import FactorGraph
from mast3r_slam_torch.inference import mast3r_inference_mono
from mast3r_slam_torch.ops.gauss_newton import GNParams, _assemble_Hg, gauss_newton_graph
from test_torch_helpers import BENCH_SETTINGS, both_configs, tiny_pair
from tests.fixtures import make_graph_problem, perturb_poses

POSE_ATOL = 1e-5


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a).copy())
    return t if dtype is None else t.to(dtype)


def _problem(seed: int, num_kf: int = 5, num_edges: int = 8, h: int = 6, w: int = 8):
    rng = np.random.default_rng(seed)
    prob = make_graph_problem(rng, num_kf=num_kf, h=h, w=w, num_edges=num_edges)
    prob["Twc0"] = perturb_poses(rng, prob["Twc_gt"], mag=0.03)
    return prob


def _solve_both(prob, free=None, edge_chunk=None, point_stride=1, max_iter=10):
    K, E = prob["Xs"].shape[0], prob["ii"].shape[0]
    free = np.arange(K) >= 1 if free is None else free
    jp = JaxGNParams(max_iter=max_iter)
    tp = GNParams(max_iter=max_iter)
    args = (prob["Twc0"], prob["Xs"], prob["Cs"], prob["ii"], prob["jj"], prob["idx"],
            prob["valid"], prob["Q"], np.ones(E, bool), free)
    jT, _ = jax_graph(*[jnp.asarray(a) for a in args], img_size=prob["img_size"], params=jp,
                      edge_chunk=edge_chunk, point_stride=point_stride)
    tT, _ = gauss_newton_graph(*[_t(a) for a in args], img_size=prob["img_size"], params=tp,
                               edge_chunk=edge_chunk, point_stride=point_stride)
    return np.asarray(jT), tT.numpy()


@pytest.mark.parametrize("variant", ["plain", "point_stride_2", "edge_chunk_2"])
def test_graph_solve_matches_jax(variant):
    prob = _problem(3)
    kw = {"point_stride": 2} if variant == "point_stride_2" else (
        {"edge_chunk": 2} if variant == "edge_chunk_2" else {})
    jT, tT = _solve_both(prob, **kw)
    np.testing.assert_allclose(tT, jT, atol=POSE_ATOL, rtol=0)
    # the solve moved the poses toward the truth
    gt = np.asarray(prob["Twc_gt"])
    assert np.abs(tT - gt)[1:, :3].max() < np.abs(np.asarray(prob["Twc0"]) - gt)[1:, :3].max()


def test_solve_variant_names_take_one_path():
    """The port's default is Config.local_opt.solve_variant ("noconcat", what
    SLAM.run passes); "base" names the same sums and gives the same bits, and
    so does a name without "bf16" that JAX does not know (JAX's rule: it takes
    the f32 sums); "+bf16" takes other bits (tests/test_torch_solve_bf16.py
    holds it to JAX)."""
    from mast3r_slam_torch.config import Config

    prob = _problem(3)
    E = prob["ii"].shape[0]
    args = [_t(a) for a in (prob["Twc0"], prob["Xs"], prob["Cs"], prob["ii"], prob["jj"],
                            prob["idx"], prob["valid"], prob["Q"], np.ones(E, bool),
                            np.arange(prob["Xs"].shape[0]) >= 1)]
    assert Config().local_opt.solve_variant == "noconcat"
    solve = lambda v: gauss_newton_graph(*args, img_size=prob["img_size"], variant=v)[0]  # noqa: E731
    default = gauss_newton_graph(*args, img_size=prob["img_size"])[0]
    assert torch.equal(default, solve("noconcat")) and torch.equal(default, solve("base"))
    assert torch.equal(default, solve("concat"))
    assert not torch.equal(default, solve("noconcat+bf16"))


def test_free_pose_without_edges_matches_jax():
    """A free pose that no edge touches: its block is the Levenberg floor
    alone, its step zero, in both."""
    prob = _problem(5, num_kf=5, num_edges=6)
    keep = (np.asarray(prob["ii"]) != 4) & (np.asarray(prob["jj"]) != 4)
    for key in ("ii", "jj", "idx", "valid", "Q"):
        prob[key] = jnp.asarray(np.asarray(prob[key])[keep])
    jT, tT = _solve_both(prob)
    np.testing.assert_allclose(tT, jT, atol=POSE_ATOL, rtol=0)
    np.testing.assert_array_equal(tT[4], np.asarray(prob["Twc0"])[4])


def test_exact_sizes_match_jax_bucketed_padding():
    """The port solves at exact sizes; JAX's FactorGraph pads keyframes
    (edge mode, pinned) and edges (masked) to buckets. Same poses."""
    prob = _problem(7, num_kf=5, num_edges=7)
    K, E = 5, 7
    K_pad, E_pad = _bucket(K, lo=2), _bucket(E)
    assert (K_pad, E_pad) == (8, 8)
    sel = np.pad(np.arange(K), (0, K_pad - K), mode="edge")
    pad = lambda a: np.pad(np.asarray(a), [(0, E_pad - E)] + [(0, 0)] * (np.ndim(a) - 1))  # noqa: E731
    free = np.zeros(K_pad, bool)
    free[1:K] = True
    edge_mask = np.arange(E_pad) < E
    jT, _ = jax_graph(*[jnp.asarray(a) for a in (
        np.asarray(prob["Twc0"])[sel], np.asarray(prob["Xs"])[sel], np.asarray(prob["Cs"])[sel],
        pad(prob["ii"]), pad(prob["jj"]), pad(prob["idx"]), pad(prob["valid"]), pad(prob["Q"]),
        edge_mask, free)], img_size=prob["img_size"], params=JaxGNParams())
    tT, _ = gauss_newton_graph(*[_t(a) for a in (
        prob["Twc0"], prob["Xs"], prob["Cs"], prob["ii"], prob["jj"], prob["idx"], prob["valid"],
        prob["Q"], np.ones(E, bool), np.arange(K) >= 1)], img_size=prob["img_size"])
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT)[:K], atol=POSE_ATOL, rtol=0)


def test_assembly_is_the_scatter_sum():
    """The incidence-product assembly equals JAX's scatter-add (exact up to
    f32 summation order) and repeats bit for bit."""
    rng = np.random.default_rng(0)
    K, E = 4, 9
    ii = rng.integers(0, K, E)
    jj = (ii + rng.integers(1, K, E)) % K
    S = rng.normal(size=(E, 7, 7)).astype(np.float32)
    b = rng.normal(size=(E, 7)).astype(np.float32)
    H_ref = np.zeros((K, K, 7, 7), np.float32)
    g_ref = np.zeros((K, 7), np.float32)
    for e in range(E):
        H_ref[ii[e], ii[e]] += S[e]
        H_ref[jj[e], jj[e]] += S[e]
        H_ref[ii[e], jj[e]] -= S[e]
        H_ref[jj[e], ii[e]] -= S[e]
        g_ref[jj[e]] += b[e]
        g_ref[ii[e]] -= b[e]
    H, g = _assemble_Hg(K, _t(ii), _t(jj), _t(S), _t(b), torch.float32)
    np.testing.assert_allclose(H.numpy(), H_ref, atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_ref, atol=1e-5, rtol=1e-6)
    H2, g2 = _assemble_Hg(K, _t(ii), _t(jj), _t(S), _t(b), torch.float32)
    assert torch.equal(H, H2) and torch.equal(g, g2)


def _arenas(jm, tm, n_kf: int, seed: int):
    """The same keyframes (tiny-model mono pointmaps of seeded images, small
    pose offsets) in the JAX and the port's arena."""
    h, w = jm._out_hw
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    jk, tk = JaxKeyframes(h, w), Keyframes(h, w, device="cpu")
    for i in range(n_kf):
        img = np.clip(np.roll(base, 2 * i, axis=1), 0, 1)
        T = np.zeros(8, np.float32)
        T[0], T[6], T[7] = 0.01 * i, 1.0, 1.0
        jf = jax_create_frame(i, jnp.asarray(img), T_WC=jnp.asarray(T))
        jf.X_canon, jf.C, jf.feat, jf.pos = jax_mono(jm, jf)
        jf.N = jf.N_updates = 1
        jk.append(jf)
        tf = create_frame(i, torch.from_numpy(img), T_WC=_t(T))
        tf.X_canon, tf.C, tf.feat, tf.pos = mast3r_inference_mono(tm, tf)
        tf.N = tf.N_updates = 1
        tk.append(tf)
    return jk, tk


def test_factor_graph_add_and_solve_matches_jax():
    settings = dict(BENCH_SETTINGS, local_opt={"max_edges": 8, "Q_conf": 0.0},
                    runtime={"keyframe_capacity": 8, "gelu_impl": "tanh"})
    with both_configs(settings):
        jm, tm = tiny_pair("linear")
        jk, tk = _arenas(jm, tm, 4, seed=2)
        jg, tg = JaxFactorGraph(jm, jk), FactorGraph(tm, tk)
        for ii, jj in (([0, 1], [1, 2]), ([0, 1, 2], [3, 3, 3])):
            assert jg.add_factors(ii, jj, min_match_frac=0.1) == tg.add_factors(
                ii, jj, min_match_frac=0.1)
        e = jg.n_edges
        assert tg.n_edges == e and tg.n_decodes == 2
        np.testing.assert_array_equal(tg.ii[:e], jg.ii[:e])
        np.testing.assert_array_equal(tg.jj[:e], jg.jj[:e])
        np.testing.assert_array_equal(tg.idx_ii2jj[:e].numpy(), np.asarray(jg.idx_ii2jj[:e]))
        np.testing.assert_array_equal(tg.valid_match_j[:e].numpy(),
                                      np.asarray(jg.valid_match_j[:e]))
        np.testing.assert_allclose(tg.Q_ii2jj[:e].numpy(), np.asarray(jg.Q_ii2jj[:e]),
                                   rtol=1e-4, atol=1e-4)
        jg.solve_GN_rays()
        tg.solve_GN_rays()
        T_j, T_t = np.asarray(jk.T_WC[:4]), tk.T_WC[:4].numpy()
        np.testing.assert_allclose(T_t, T_j, atol=5e-4, rtol=0)
        assert np.abs(T_t[1:] - np.asarray([[0.01 * i, 0, 0, 0, 0, 0, 1, 1]
                                            for i in range(1, 4)])).max() > 0  # it moved
        # the edge-degree and eviction bookkeeping agree
        np.testing.assert_array_equal(tg.edge_degree(4), jg.edge_degree(4))
        assert tg.remove_keyframe(1) == jg.remove_keyframe(1)
        np.testing.assert_array_equal(tg.ii[:tg.n_edges], jg.ii[:jg.n_edges])
        np.testing.assert_array_equal(tg.idx_jj2ii[:tg.n_edges].numpy(),
                                      np.asarray(jg.idx_jj2ii[:jg.n_edges]))
        assert tg.prune_to_window(2, window_size=1) == jg.prune_to_window(2, window_size=1)
        assert tg.n_edges == jg.n_edges
        np.testing.assert_array_equal(tg.jj[:tg.n_edges], jg.jj[:jg.n_edges])
        np.testing.assert_array_equal(tg.valid_match_i[:tg.n_edges].numpy(),
                                      np.asarray(jg.valid_match_i[:jg.n_edges]))
        # the points-mode solve from the same pruned graph and arena state
        jg.solve_GN_points()
        tg.solve_GN_points()
        np.testing.assert_allclose(tk.T_WC[:4].numpy(), np.asarray(jk.T_WC[:4]), atol=5e-4,
                                   rtol=0)
        assert dataclasses.is_dataclass(tk[0])


def test_symmetric_batch_decode_matches_jax():
    """`mast3r_decode_symmetric_batch`: two keyframe pairs decoded both ways
    in one batch, (ii, ji, jj, ij) order; within 1e-4 (the tiny models' f32
    outputs, as in test_torch_model.py)."""
    from mast3r_slam_tpu.inference import mast3r_decode_symmetric_batch as jax_sym
    from mast3r_slam_torch.inference import mast3r_decode_symmetric_batch

    with both_configs(dict(BENCH_SETTINGS)):
        jm, tm = tiny_pair("linear")
        jk, tk = _arenas(jm, tm, 3, seed=4)
        sel_i, sel_j = [0, 1], [1, 2]
        j_out = jax_sym(jm, jk._feat[np.array(sel_i)], jnp.stack([jk._pos] * 2),
                        jk._feat[np.array(sel_j)], jnp.stack([jk._pos] * 2))
        t_out = mast3r_decode_symmetric_batch(
            tm, tk._feat[sel_i], tk._pos[None].expand(2, *tk._pos.shape),
            tk._feat[sel_j], tk._pos[None].expand(2, *tk._pos.shape))
    for name, a, b in zip("XCDQ", t_out, j_out):
        assert tuple(a.shape) == tuple(b.shape), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4, err_msg=name)
