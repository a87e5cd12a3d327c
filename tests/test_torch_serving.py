"""The port's serving path (`mast3r_slam_torch.serving.BatchTracker`) against
JAX's `BatchTracker` on the CPU, at B = 3 streams of the conftest tiny model
(the port's copy carries the same flax weights), and the batched rays pose
solve against JAX's `gauss_newton_pose_rays` vmapped over the streams.

Each package encodes the same numpy-seeded images itself. Bands are those of
tests/test_serving.py for the same quantities: stats and poses rtol 2e-4 /
atol 2e-5, pointmaps rtol 2e-3 / atol 2e-4; microbatch against flat in the
port is held bit-equal where the arithmetic is the same per stream (the
chunks are slices of one batch), else within the same bands.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.lie import core as jlie
from mast3r_slam_tpu.ops.gauss_newton import GNParams as JaxGNParams
from mast3r_slam_tpu.ops.gauss_newton import gauss_newton_pose_rays as jax_pose_rays
from mast3r_slam_tpu.serving import BatchTracker as JaxBatchTracker
from mast3r_slam_torch.ops.gauss_newton import GNParams, gauss_newton_pose_rays
from mast3r_slam_torch.serving import BatchTracker
from test_torch_helpers import BENCH_SETTINGS, both_configs, tiny_pair

STATS = dict(rtol=2e-4, atol=2e-5)
POINTS = dict(rtol=2e-3, atol=2e-4)
SIMPLE = {"matching": {"use_simple": True, "dist_thresh": 1e6},
          "tracking": {"min_match_frac": 0.01}}


@pytest.fixture(scope="module")
def models():
    """A JAX tiny model of its own (JAX reads `runtime.gelu_impl` when a jit
    traces, so a model shared with other files may carry another setting)
    and the port's copy; every test here runs the exact GELU."""
    return tiny_pair("linear")


def _settings(matcher: str) -> dict:
    """The simple matcher of JAX's serving tests, or bench.py's dense matcher
    and gates, with the exact GELU of the other tests."""
    if matcher == "simple":
        return SIMPLE
    s = copy.deepcopy(BENCH_SETTINGS)
    del s["runtime"]
    s["tracking"]["min_match_frac"] = 0.01
    return s


def _images(seed: int, b: int, hw=(48, 64)) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (b,) + hw + (3,)).astype(np.float32)


def _keyframes(jm, tm, imgs):
    """Each package's encode and mono pointmap of the same [0, 1] images ->
    ((feats, poss, Xs, Cs) of JAX, the same of the port)."""
    x = imgs * 2.0 - 1.0
    jf, jp = jm.encode(jnp.asarray(x))
    tf, tp = tm.encode(torch.from_numpy(x))
    jmono = [jm.mono(jf[i], jp[i]) for i in range(len(imgs))]
    tmono = [tm.mono(tf[i], tp[i]) for i in range(len(imgs))]
    j = (jf, jp, jnp.stack([m[0] for m in jmono]), jnp.stack([m[1] for m in jmono]))
    t = (tf, tp, torch.stack([m[0] for m in tmono]), torch.stack([m[1] for m in tmono]))
    return j, t


def _encode(jm, tm, imgs):
    x = imgs * 2.0 - 1.0
    return jm.encode(jnp.asarray(x)), tm.encode(torch.from_numpy(x))


def _assert_state_close(tb, jb):
    s, r = tb.state, jb.state
    np.testing.assert_allclose(s.T_WC.numpy(), np.asarray(r.T_WC), **STATS)
    for k in ("kf_X", "kf_C", "fr_X", "fr_C"):
        np.testing.assert_allclose(getattr(s, k).numpy(), np.asarray(getattr(r, k)), **POINTS,
                                   err_msg=k)
    for k in ("kf_N", "fr_N"):
        np.testing.assert_array_equal(getattr(s, k).numpy(), np.asarray(getattr(r, k)))


@pytest.mark.parametrize("matcher", ["simple", "dense"])
def test_feature_and_image_steps_match_jax(models, matcher):
    """Two feature-fed steps, then one image-fed step (uint8 frames through
    the one batched encode): stats, poses and the whole state."""
    jm, tm = models
    with both_configs(_settings(matcher)):
        (jk, tk) = _keyframes(jm, tm, _images(0, 3))
        jb, tb = JaxBatchTracker(jm), BatchTracker(tm)
        jb.init_from_keyframes(*jk)
        tb.init_from_keyframes(*tk)
        for seed in (1, 2):
            (jf, jp), (tf, tp) = _encode(jm, tm, _images(seed, 3))
            jout, tout = jb.step(jf, jp), tb.step(tf, tp)
            np.testing.assert_allclose(tout["match_frac"], jout["match_frac"], **STATS)
            np.testing.assert_array_equal(tout["tracked"], jout["tracked"])
            np.testing.assert_array_equal(tout["new_kf"], jout["new_kf"])
            np.testing.assert_allclose(tout["poses"].numpy(), np.asarray(jout["poses"]), **STATS)
            assert tout["tracked"].all()
            _assert_state_close(tb, jb)
        u8 = (_images(3, 3) * 255).astype(np.uint8)
        js, ts = jb.step_images_async(jnp.asarray(u8)), tb.step_images_async(torch.from_numpy(u8))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **STATS)
        _assert_state_close(tb, jb)


def test_microbatch_matches_flat_and_jax(models):
    """B = 4 in chunks of 2 against one flat pass (port and JAX), and an
    indivisible B = 3 at microbatch 2, which runs flat as in JAX."""
    jm, tm = models
    with both_configs(SIMPLE):
        (jk, tk) = _keyframes(jm, tm, _images(4, 4))
        (jf, jp), (tf, tp) = _encode(jm, tm, _images(5, 4))
        outs = {}
        for mb in (0, 2):
            tb = BatchTracker(tm, microbatch=mb)
            tb.init_from_keyframes(*tk)
            outs[mb] = (tb.step(tf, tp), tb.state)
        jb = JaxBatchTracker(jm, microbatch=2)
        jb.init_from_keyframes(*jk)
        jout = jb.step(jf, jp)
        np.testing.assert_allclose(outs[2][0]["poses"].numpy(), outs[0][0]["poses"].numpy(),
                                   **STATS)
        np.testing.assert_allclose(outs[2][1].kf_X.numpy(), outs[0][1].kf_X.numpy(), **POINTS)
        np.testing.assert_allclose(outs[2][0]["poses"].numpy(), np.asarray(jout["poses"]),
                                   **STATS)
        np.testing.assert_allclose(outs[2][1].kf_X.numpy(), np.asarray(jb.state.kf_X), **POINTS)

        tb3 = BatchTracker(tm, microbatch=2)
        flat3 = BatchTracker(tm, microbatch=0)
        for bt in (tb3, flat3):
            bt.init_from_keyframes(*(a[:3] for a in tk))
        s3, f3 = tb3.step_async(tf[:3], tp[:3]), flat3.step_async(tf[:3], tp[:3])
        assert tb3.microbatch == 2
        torch.testing.assert_close(s3, f3, rtol=0, atol=0)
        torch.testing.assert_close(tb3.state.T_WC, flat3.state.T_WC, rtol=0, atol=0)


def test_slot_lifecycle_and_keyframe_update_match_jax(models):
    """close_slot masks a lane; open_slot starts a new stream in it;
    update_keyframes promotes a subset: each against JAX doing the same."""
    jm, tm = models
    with both_configs(SIMPLE):
        (jk, tk) = _keyframes(jm, tm, _images(6, 3))
        (jn, tn) = _keyframes(jm, tm, _images(7, 1))
        (jf, jp), (tf, tp) = _encode(jm, tm, _images(8, 3))
        jb, tb = JaxBatchTracker(jm), BatchTracker(tm)
        jb.init_from_keyframes(*jk)
        tb.init_from_keyframes(*tk)
        np.testing.assert_array_equal(tb.close_slot(1), np.asarray(jb.close_slot(1)))
        jout, tout = jb.step(jf, jp), tb.step(tf, tp)
        assert list(tout["active"]) == list(jout["active"]) == [True, False, True]
        np.testing.assert_array_equal(tout["tracked"], jout["tracked"])
        assert not tout["tracked"][1] and not tout["new_kf"][1]

        jb.open_slot(1, *(a[0] for a in jn))
        tb.open_slot(1, *(a[0] for a in tn))
        jf2, jp2 = jf.at[1].set(jn[0][0]), jp.at[1].set(jn[1][0])
        tf2, tp2 = tf.clone(), tp.clone()
        tf2[1], tp2[1] = tn[0][0], tn[1][0]
        jout, tout = jb.step(jf2, jp2), tb.step(tf2, tp2)
        assert tout["tracked"].all() and tout["active"].all()
        np.testing.assert_allclose(tout["poses"].numpy(), np.asarray(jout["poses"]), **STATS)
        _assert_state_close(tb, jb)

        sel = [0, 2]
        jb.update_keyframes(np.asarray(sel), *(a[np.asarray(sel)] for a in jk))
        tb.update_keyframes(sel, *(a[sel] for a in tk))
        assert float(tb.state.kf_N[0]) == 1.0 and float(tb.state.fr_N[0]) == 0.0
        _assert_state_close(tb, jb)
        np.testing.assert_allclose(tb.state.kf_T.numpy(), np.asarray(jb.state.kf_T), **STATS)
        jout, tout = jb.step(jf, jp), tb.step(tf, tp)
        assert tout["tracked"].all()
        np.testing.assert_allclose(tout["poses"].numpy(), np.asarray(jout["poses"]), **STATS)
        _assert_state_close(tb, jb)


def test_async_chain_matches_sync_steps(models):
    """step_async chained three times, the stats read once at the end, is
    the synchronous step by step (bit-equal: the same calls), and each
    handle is JAX's."""
    jm, tm = models
    with both_configs(SIMPLE):
        (jk, tk) = _keyframes(jm, tm, _images(9, 3))
        encs = [_encode(jm, tm, _images(10 + i, 3)) for i in range(3)]
        sync = BatchTracker(tm)
        sync.init_from_keyframes(*tk)
        sync_out = [sync.step(*t) for _, t in encs]
        asy = BatchTracker(tm)
        asy.init_from_keyframes(*tk)
        handles = [asy.step_async(*t) for _, t in encs]
        final = asy.resolve_stats(handles[-1])
        torch.testing.assert_close(final["poses"], sync_out[-1]["poses"], rtol=0, atol=0)
        torch.testing.assert_close(asy.state.kf_X, sync.state.kf_X, rtol=0, atol=0)
        jb = JaxBatchTracker(jm)
        jb.init_from_keyframes(*jk)
        jhandles = [jb.step_async(*j) for j, _ in encs]
        for h, jh, ref in zip(handles, jhandles, sync_out):
            np.testing.assert_array_equal(h[:, 0].numpy(), ref["match_frac"])
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), **STATS)


def test_per_sequence_isolation(models):
    """Another frame in stream 1 leaves streams 0 and 2 as they were (and
    static streams track at identity, as in JAX's test)."""
    jm, tm = models
    with both_configs(SIMPLE):
        (_, tk) = _keyframes(jm, tm, _images(11, 3))
        feats, poss = tk[0], tk[1]
        _, (fo, _po) = _encode(jm, tm, _images(12, 1))
        runs = []
        for f in (feats, torch.cat([feats[:1], fo, feats[2:]])):
            tb = BatchTracker(tm)
            tb.init_from_keyframes(*tk)
            runs.append((tb.step(f, poss), tb.state))
        (clean, s_clean), (mixed, s_mixed) = runs
        for b in (0, 2):
            np.testing.assert_allclose(mixed["poses"][b].numpy(), clean["poses"][b].numpy(),
                                       **STATS)
            np.testing.assert_allclose(s_mixed.kf_X[b].numpy(), s_clean.kf_X[b].numpy(),
                                       **POINTS)
            np.testing.assert_allclose(clean["poses"][b, :3].numpy(), 0.0, atol=0.05)
            np.testing.assert_allclose(clean["poses"][b, 3:7].numpy(), [0, 0, 0, 1], atol=0.05)
        assert not np.allclose(mixed["poses"][1].numpy(), clean["poses"][1].numpy(), atol=1e-4)


def _gn_streams(seed: int, b: int = 4, n: int = 1024):
    """Streams of a ray-distance problem whose poses converge at different
    iterations (growing perturbations), the last with zero weights."""
    rng = np.random.default_rng(seed)
    T0, Xf, rd, w = [], [], [], []
    for i in range(b):
        Xk = (rng.normal(size=(n, 3)) * [1.0, 0.7, 0.5] + [0, 0, 3]).astype(np.float32)
        xi = (rng.normal(size=7) * 0.02 * (i + 1)).astype(np.float32)
        T = np.asarray(jlie.sim3_exp(jnp.asarray(xi)))
        Xf.append(np.asarray(jlie.sim3_act(jlie.sim3_inv(jnp.asarray(T)), jnp.asarray(Xk)))
                  + rng.normal(0, 1e-3, (n, 3)).astype(np.float32))
        d = np.linalg.norm(Xk, axis=-1, keepdims=True)
        rd.append(np.concatenate([Xk / d, d], -1).astype(np.float32))
        wi = rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
        w.append(np.concatenate([np.repeat(wi / 0.003, 3, -1), wi / 10.0], -1) * (i < b - 1))
        T0.append(np.asarray(jlie.sim3_identity()))
    return [np.stack(a).astype(np.float32) for a in (T0, Xf, rd, w)]


def test_batched_pose_gn_matches_vmapped_jax():
    """The batched solve against JAX's solve vmapped over the streams, with
    a negative Levenberg floor so that the zero-weight stream's system
    (H = 0, H + reg I = -I) is not positive definite: that stream takes zero
    steps (it keeps T_init), the others are unaffected (bit-equal to each
    solved alone) and converge at their own iterations."""
    T0, Xf, rd, w = _gn_streams(3)
    jp, tp = JaxGNParams(reg=-1.0), GNParams(reg=-1.0)
    jT, jcost = jax.vmap(lambda *a: jax_pose_rays(*a, jp))(*map(jnp.asarray, (T0, Xf, rd, w)))
    tT, tcost = gauss_newton_pose_rays(*map(torch.from_numpy, (T0, Xf, rd, w)), tp)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tcost[:-1].numpy(), np.asarray(jcost)[:-1], rtol=1e-4)
    np.testing.assert_array_equal(tT[-1].numpy(), T0[-1])
    assert not np.allclose(tT[:-1].numpy(), T0[:-1], atol=1e-3)
    for i in range(len(T0)):
        alone, _ = gauss_newton_pose_rays(*(torch.from_numpy(a[i]) for a in (T0, Xf, rd, w)), tp)
        np.testing.assert_allclose(tT[i].numpy(), alone.numpy(), rtol=0, atol=1e-6)
