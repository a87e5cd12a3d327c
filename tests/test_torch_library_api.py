"""The JAX package's library surface in the port, each function held to its
JAX counterpart on the same numpy-seeded inputs: the closed-form and Schur
solves (`ops.linalg`), the generic robust Gauss-Newton (`GaussNewtonSolver`),
the `Keyframes` accessors and the relocalisation queue (`frame`), symmetric
inference and `MASt3RModel.reconstruct` on the tiny model, the on-device
resize (`models.preprocess.resize_image_device`), `dequantize_module`
against `dequantize_params`, `RetrievalDatabase.prep_features`,
`geometry.skew_sym`, `models.heads.tokens_to_grid`, `BatchTracker.open_slot`
by keyword, and the package's top-level exports.

Bands: f32 arithmetic in other orders, 1e-5 relative for the solves and the
solver (the solver's iteration count exactly); the network's outputs the
bands of tests/test_torch_model.py; the resize 1e-5 in f32 and exact in
uint8; the dequantized weights and the Keyframes slices exact.
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mast3r_slam_tpu
import mast3r_slam_torch
from mast3r_slam_tpu import frame as jax_frame
from mast3r_slam_tpu import geometry as jax_geometry
from mast3r_slam_tpu import inference as jax_inference
from mast3r_slam_tpu import retrieval_db as jax_db
from mast3r_slam_tpu.models import heads as jax_heads
from mast3r_slam_tpu.models import preprocess as jax_preprocess
from mast3r_slam_tpu.ops import gauss_newton as jax_gn
from mast3r_slam_tpu.ops import linalg as jax_linalg
from mast3r_slam_torch import frame, geometry, inference, retrieval_db
from mast3r_slam_torch.models import heads, preprocess
from mast3r_slam_torch.models.quant import dequantize_module, quantize_module
from mast3r_slam_torch.ops import gauss_newton, linalg
from test_torch_helpers import both_configs, tiny_pair
from test_torch_model import _assert_pts_close
from test_torch_quant import _jax_quantized
from test_torch_retrieval import _head_params_from_jax, _Model, _tokens


def _close(ours, ref, rtol=1e-5, atol=1e-6, **kw):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=rtol, atol=atol, **kw)


def _systems(n: int, k: int, singular: bool, seed: int):
    """k systems A [k, n, n], b [k, n]; `singular` makes each A's determinant
    tiny (a row is another row plus 1e-7), which the determinant clamp meets."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(k, n, n)).astype(np.float32)
    if singular:
        A[:, 1] = A[:, 0] + np.float32(1e-7)
    A[0] = 0.0  # a zero determinant: the clamp's value itself
    return A, rng.normal(size=(k, n)).astype(np.float32)


@pytest.mark.parametrize("singular", [False, True])
@pytest.mark.parametrize("damping", [0.0, 0.5])
@pytest.mark.parametrize("n", [2, 3])
def test_closed_form_solves_match_jax(n, damping, singular):
    A, b = _systems(n, 6, singular, seed=n)
    ours = getattr(linalg, f"solve_{n}x{n}")(torch.from_numpy(A), torch.from_numpy(b), damping)
    ref = getattr(jax_linalg, f"solve_{n}x{n}")(jnp.asarray(A), jnp.asarray(b), damping)
    assert ours.shape == ref.shape == (6, n)
    _close(ours, ref)
    if not singular:  # well-posed rows solve the damped system
        A_d = A[1:] + damping * np.eye(n, dtype=np.float32)
        np.testing.assert_allclose(np.einsum("kij,kj->ki", A_d, ours[1:].numpy()), b[1:],
                                   atol=1e-4)


def test_sparse_schur_solve_matches_jax_and_the_dense_solve():
    rng = np.random.default_rng(2)
    P, L = 6, 20
    M = rng.normal(size=(P, P))
    Hpp = (M @ M.T + P * np.eye(P)).astype(np.float32)
    Hpl = (0.3 * rng.normal(size=(P, L))).astype(np.float32)
    Hll_diag = rng.uniform(2.0, 4.0, size=L).astype(np.float32)
    gp, gl = rng.normal(size=P).astype(np.float32), rng.normal(size=L).astype(np.float32)
    xp, xl = linalg.sparse_schur_solve(*(torch.from_numpy(a) for a in (Hpp, Hpl, Hll_diag,
                                                                          gp, gl)))
    rp, rl = jax_linalg.sparse_schur_solve(*(jnp.asarray(a) for a in (Hpp, Hpl, Hll_diag,
                                                                       gp, gl)))
    _close(xp, rp, rtol=1e-4, atol=1e-5)
    _close(xl, rl, rtol=1e-4, atol=1e-5)
    full = np.block([[Hpp, Hpl], [Hpl.T, np.diag(Hll_diag)]]).astype(np.float64)
    x = np.linalg.solve(full + 1e-6 * np.eye(P + L), np.concatenate([gp, gl]))
    np.testing.assert_allclose(np.concatenate([xp.numpy(), xl.numpy()]), x, rtol=1e-3, atol=1e-4)


def _line_problem(seed: int, outliers: int):
    """JAX's tests/test_gauss_newton.py fit: y = 2x - 1 + noise, with
    `outliers` of the 128 samples moved by N(0, 5)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=128).astype(np.float32)
    y = 2.0 * x - 1.0 + rng.normal(size=128).astype(np.float32) * 0.01
    bad = rng.choice(128, outliers, replace=False)
    y[bad] += (rng.normal(size=outliers) * 5.0).astype(np.float32)
    return x, y


def _residuals(lib, x, y):
    if lib is jnp:
        def fn(p):
            return p[0] * x + p[1] - y, jnp.stack([x, jnp.ones_like(x)], axis=-1)
    else:
        def fn(p):
            return p[0] * x + p[1] - y, torch.stack([x, torch.ones_like(x)], dim=-1)
    return fn


@pytest.mark.parametrize("outliers,max_iter", [(25, 30), (0, 30), (25, 3)])
def test_gauss_newton_solver_matches_jax(outliers, max_iter):
    """Huber warm start, then the Tukey polish (JAX's outlier fit); each
    solve's x, cost and iteration count against JAX's while_loop. At
    max_iter 3 the loop is cut by the count, not by the rule."""
    x, y = _line_problem(0, outliers)
    fns = _residuals(jnp, jnp.asarray(x), jnp.asarray(y)), _residuals(
        torch, torch.from_numpy(x), torch.from_numpy(y))
    x0 = np.asarray([1.0, 0.0], np.float32)
    ref_x, our_x = jnp.asarray(x0), torch.from_numpy(x0)
    iters = []
    for kw in (dict(robust="huber", huber_k=0.5), dict(robust="tukey", tukey_t=0.5)):
        kw.update(max_iter=max_iter, delta_thresh=1e-10)
        ref_x, ref_cost, ref_it = jax_gn.GaussNewtonSolver(jax_gn.GNParams(**kw)).solve(
            fns[0], ref_x, jnp.ones(128))
        our_x, our_cost, our_it = gauss_newton.GaussNewtonSolver(
            gauss_newton.GNParams(**kw)).solve(fns[1], our_x, torch.ones(128))
        assert our_it.dtype == torch.int32 and our_it.shape == ()
        assert int(our_it) == int(ref_it)
        _close(our_x, ref_x)
        _close(our_cost, ref_cost, rtol=1e-4)
        iters.append(int(our_it))
    if outliers and max_iter == 30:
        np.testing.assert_allclose(our_x.numpy(), [2.0, -1.0], atol=5e-3)
    assert iters[0] <= max_iter and (max_iter > 3 or iters == [3, 3])


def test_gauss_newton_solver_zero_step_on_a_singular_system():
    """A system that is not positive definite gives NaN from the Cholesky;
    the finiteness guard makes it a zero step, as in JAX."""
    def fn(p):
        return p - 1.0, torch.full((2, 2), float("nan"))

    def fn_jax(p):
        return p - 1.0, jnp.full((2, 2), jnp.nan)

    x, cost, it = gauss_newton.GaussNewtonSolver().solve(fn, torch.zeros(2), torch.ones(2))
    rx, rcost, rit = jax_gn.GaussNewtonSolver().solve(fn_jax, jnp.zeros(2), jnp.ones(2))
    assert torch.equal(x, torch.zeros(2)) and np.array_equal(np.asarray(rx), np.zeros(2))
    # the zero step's norm is under delta_thresh: both loops stop after one
    assert int(it) == int(rit) == 1 and float(cost) == float(rcost) == 1.0


def _append_frames(mod, kfs, n, rng):
    as_t = (lambda a: torch.from_numpy(a)) if mod is frame else jnp.asarray
    for i in range(n):
        X = rng.normal(size=(12, 3)).astype(np.float32)
        C = rng.uniform(0.5, 2.0, size=(12, 1)).astype(np.float32)
        T = np.concatenate([rng.normal(size=3), [0, 0, 0, 1], [1.5]]).astype(np.float32)
        f = mod.Frame(frame_id=10 + i, img=as_t(np.zeros((3, 4, 3), np.float32)), T_WC=as_t(T),
                      X_canon=as_t(X), C=as_t(C), N=i + 1, N_updates=i + 1)
        kfs.append(f)


def test_keyframes_accessors_match_jax():
    with both_configs({"runtime": {"keyframe_capacity": 6}}):
        ours, ref = frame.Keyframes(3, 4, device="cpu"), jax_frame.Keyframes(3, 4)
        assert ours.count == ref.count == 0
        assert ours.last_keyframe() is None and ref.last_keyframe() is None
        for mod, kfs in ((frame, ours), (jax_frame, ref)):
            _append_frames(mod, kfs, 4, np.random.default_rng(0))
            kfs.remove(1)
        assert ours.count == ref.count == 3
        for get in ("get_poses", "get_points", "get_confidences", "get_average_conf_arena"):
            a, b = getattr(ours, get)(), getattr(ref, get)()
            assert tuple(a.shape) == b.shape, get
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=get)
        a, b = ours.last_keyframe(), ref.last_keyframe()
        assert a.frame_id == b.frame_id == 13 and a.N == b.N == 4
        np.testing.assert_array_equal(a.X_canon.numpy(), np.asarray(b.X_canon))
        np.testing.assert_array_equal(a.T_WC_sim3.data.numpy(), np.asarray(b.T_WC_sim3.data))


def test_reloc_queue_matches_jax():
    ours, ref = frame.SLAMState(), jax_frame.SLAMState()
    got = []
    for op in ("d", "q", "q", "d", "q", "d", "d", "d"):
        if op == "q":
            ours.queue_reloc()
            ref.queue_reloc()
        else:
            got.append((ours.dequeue_reloc(), ref.dequeue_reloc()))
        assert ours.reloc_pending == ref.reloc_pending
    assert [a for a, _ in got] == [b for _, b in got] == [False, True, True, True, False]


@pytest.fixture(scope="module")
def models():
    return tiny_pair("linear")


def _assert_outputs_close(ours: dict, ref: dict, tag: str):
    _assert_pts_close(ours["pts3d"].numpy(), np.asarray(ref["pts3d"]), tag)
    for key in ("conf", "desc", "desc_conf"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=2e-4,
                                   rtol=1e-3, err_msg=f"{tag} {key}")


def test_symmetric_inference_matches_jax(models):
    jm, tm = models
    h, w = jm._out_hw
    rng = np.random.default_rng(4)
    imgs = [rng.uniform(0, 1, (h, w, 3)).astype(np.float32) for _ in range(2)]
    with both_configs({}):
        ours = inference.mast3r_symmetric_inference(
            tm, *(frame.create_frame(i, im) for i, im in enumerate(imgs)))
        ref = jax_inference.mast3r_symmetric_inference(
            jm, *(jax_frame.create_frame(i, jnp.asarray(im)) for i, im in enumerate(imgs)))
    assert len(ours) == 4
    assert [tuple(a.shape) for a in ours] == [b.shape for b in ref]
    assert ours[0].shape[:3] == (4, h, w)
    names = ("pts3d", "conf", "desc", "desc_conf")
    _assert_outputs_close(dict(zip(names, ours)), dict(zip(names, ref)), "symmetric")


def test_reconstruct_matches_jax(models):
    """Two pairs in one call: each view encoded, one decode of the batch."""
    jm, tm = models
    h, w = jm._out_hw
    rng = np.random.default_rng(6)
    img1, img2 = (rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32) for _ in range(2))
    ours = tm.reconstruct(torch.from_numpy(img1), torch.from_numpy(img2))
    ref = jm.reconstruct(jnp.asarray(img1), jnp.asarray(img2))
    for o, r, tag in zip(ours, ref, ("view 1", "view 2")):
        assert tuple(o["pts3d"].shape) == r["pts3d"].shape == (2, h, w, 3)
        _assert_outputs_close(o, r, tag)


RESIZE_CASES = {
    "hwc f32 long edge": ((30, 40, 3), np.float32, 25, True),
    "chw f32 tuple": ((3, 30, 40), np.float32, (17, 53), True),
    "hwc uint8 long edge": ((30, 40, 3), np.uint8, 64, True),
    "chw uint8 square": ((4, 24, 40), np.uint8, 20, False),
    "hwc f32 square": ((30, 40, 1), np.float32, 16, False),
    "hwc f32 same size": ((30, 40, 3), np.float32, (30, 40), True),
}


@pytest.mark.parametrize("case", list(RESIZE_CASES))
def test_resize_image_device_matches_jax(case):
    shape, dtype, target, keep = RESIZE_CASES[case]
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, shape).astype(dtype)
    ours = preprocess.resize_image_device(torch.from_numpy(img), target, keep_aspect=keep)
    ref = jax_preprocess.resize_image_device(jnp.asarray(img), target, keep_aspect=keep)
    assert tuple(ours.shape) == ref.shape and ours.dtype == torch.from_numpy(img).dtype
    if dtype == np.uint8:
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    else:
        _close(ours, ref, atol=1e-4)


@pytest.mark.parametrize("head_type,dtype", [("linear", "float32"), ("dpt", "bfloat16")])
def test_dequantize_module_matches_dequantize_params(head_type, dtype):
    jm, tm = tiny_pair(head_type)
    want = _jax_quantized(jm.params, getattr(jnp, dtype))
    img = torch.from_numpy(np.random.default_rng(8).uniform(
        -1, 1, (1,) + tm.out_hw + (3,)).astype(np.float32))
    names = quantize_module(tm.net, torch.float32)
    quantized = tm.encode(img)[0]
    assert sorted(dequantize_module(tm.net, getattr(torch, dtype))) == sorted(names)
    params = dict(tm.net.named_parameters())
    for name in names:
        layer = tm.net.get_submodule(name.rpartition(".")[0])
        assert not hasattr(layer, "weight_q") and layer.quant_dtype is None
        got = params[name]
        assert got.dtype == getattr(torch, dtype), name
        np.testing.assert_array_equal(got.float().numpy(), want[name][2].astype(np.float32),
                                      err_msg=name)
    if dtype == "float32":  # the layers compute what they computed quantized
        assert torch.equal(tm.encode(img)[0], quantized)


@pytest.mark.parametrize("dim", [16, 1024])
def test_prep_features_matches_jax(dim):
    with both_configs({"runtime": {"keyframe_capacity": 4}}):
        j = jax_db.load_retriever(_Model(dim))
        t = retrieval_db.load_retriever(_Model(dim))
        if dim == 1024:
            t.retrieval.params = _head_params_from_jax(j.retrieval)
        feat = _tokens(np.random.default_rng(dim), 1, 6, dim)[0]
        ours, ref = t.prep_features(torch.from_numpy(feat)), j.prep_features(jnp.asarray(feat))
    assert tuple(ours.shape) == ref.shape
    _close(ours, ref, atol=1e-5)


def test_skew_sym_and_tokens_to_grid_match_jax():
    rng = np.random.default_rng(9)
    v = rng.normal(size=(5, 3)).astype(np.float32)
    S = geometry.skew_sym(torch.from_numpy(v))
    np.testing.assert_array_equal(S.numpy(), np.asarray(jax_geometry.skew_sym(jnp.asarray(v))))
    np.testing.assert_allclose(np.einsum("kij,kj->ki", S.numpy(), v), 0.0, atol=1e-6)
    tok = rng.normal(size=(2, 12, 5)).astype(np.float32)
    grid = heads.tokens_to_grid(torch.from_numpy(tok), 3, 4)
    np.testing.assert_array_equal(grid.numpy(),
                                  np.asarray(jax_heads.tokens_to_grid(jnp.asarray(tok), 3, 4)))


def test_open_slot_takes_poss_by_keyword(models):
    """JAX's parameter name: a keyword call runs in both packages and
    leaves the same lane."""
    from mast3r_slam_tpu.serving import BatchTracker as JaxBatchTracker
    from mast3r_slam_torch.serving import BatchTracker

    jm, tm = models
    x = np.random.default_rng(10).uniform(-1, 1, (2,) + tm.out_hw + (3,)).astype(np.float32)
    with both_configs({"matching": {"use_simple": True}}):
        jf, jp = jm.encode(jnp.asarray(x))
        tf, tp = tm.encode(torch.from_numpy(x))
        jX, jC = zip(*(jm.mono(jf[i], jp[i]) for i in range(2)))
        tX, tC = zip(*(tm.mono(tf[i], tp[i]) for i in range(2)))
        jb, tb = JaxBatchTracker(jm), BatchTracker(tm)
        jb.init_from_keyframes(jf, jp, jnp.stack(jX), jnp.stack(jC))
        tb.init_from_keyframes(tf, tp, torch.stack(tX), torch.stack(tC))
        jb.close_slot(1)
        tb.close_slot(1)
        jb.open_slot(1, feat=jf[0], poss=jp[0], X=jX[0], C=jC[0])
        tb.open_slot(1, feat=tf[0], poss=tp[0], X=tX[0], C=tC[0])
    assert list(tb.active) == [True, True]
    np.testing.assert_array_equal(tb.state.kf_pos[1].numpy(), np.asarray(jb.state.kf_pos[1]))
    _assert_pts_close(tb.state.kf_X[1].numpy(), np.asarray(jb.state.kf_X[1]), "slot 1")


LAZY = ("SLAM", "load_mast3r", "OfflineReconstructor", "BatchTracker", "LiveViewer")


@pytest.mark.parametrize("name", LAZY)
def test_lazy_top_level_exports(name):
    import importlib

    module, attr = mast3r_slam_torch._LAZY[name]
    assert getattr(mast3r_slam_torch, name) is getattr(importlib.import_module(module), attr)
    assert module.replace("mast3r_slam_torch", "mast3r_slam_tpu") == mast3r_slam_tpu._LAZY[name][0]


def test_top_level_names_and_default_config():
    from mast3r_slam_torch.config import Config

    assert mast3r_slam_torch.__all__ == mast3r_slam_tpu.__all__
    assert set(mast3r_slam_torch._LAZY) == set(mast3r_slam_tpu._LAZY) == set(LAZY)
    assert mast3r_slam_torch.__version__ == mast3r_slam_tpu.__version__
    assert mast3r_slam_torch.default_config() == Config()
    assert mast3r_slam_torch.default_config() is not mast3r_slam_torch.default_config()
    assert dataclasses.asdict(mast3r_slam_torch.default_config()) == dataclasses.asdict(
        mast3r_slam_torch.get_config())
    with pytest.raises(AttributeError, match="no attribute"):
        mast3r_slam_torch.NoSuchName  # noqa: B018
    # importing the package loads neither torch nor any of its submodules
    # but the config, and never jax
    code = ("import sys, mast3r_slam_torch; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'mast3r_slam_torch', 'mast3r_slam_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=mast3r_slam_torch.__path__[0] + "/..")
    assert out.stdout.split() == ["['mast3r_slam_torch',", "'mast3r_slam_torch.config']"]
