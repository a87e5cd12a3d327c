"""Sharded serving and the edge-sharded graph solve of the port
(`BatchTracker(mesh=)`, `gauss_newton_graph(mesh=)`, `FactorGraph(mesh=)`)
on gloo process groups on the CPU, against the port unsharded and against
JAX's sharded functions on the conftest's virtual devices.

Serving runs the tiny model (its copy carries the same flax weights) at B 4
with the simple matcher of tests/test_torch_serving.py: two feature-fed
steps, a promotion of two streams that live on different dp ranks, a closed
and reopened slot, one image-fed step; at dp 2 x tp 2 (4 ranks) and at tp 2
(2 ranks), microbatch 2. Bands: those of tests/test_torch_serving.py, stats
and poses rtol 2e-4 / atol 2e-5, pointmaps rtol 2e-3 / atol 2e-4; tracked
flags exact. The solves run at dp 4 against JAX's at dp 4, within JAX's
dryrun band 1e-4 (__graft_entry__.py), rays, calib and their +bf16 variant.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops.gauss_newton import GNParams as JaxGNParams
from mast3r_slam_tpu.ops.gauss_newton import gauss_newton_graph as jax_graph
from mast3r_slam_tpu.parallel import make_mesh as jax_make_mesh
from mast3r_slam_tpu.serving import BatchTracker as JaxBatchTracker
from mast3r_slam_torch.parallel.mesh import spawn
from test_torch_helpers import both_configs, tiny_pair
from test_torch_parallel_workers import serving_run, serving_rank
from tests.fixtures import make_graph_problem, perturb_poses

STATS = dict(rtol=2e-4, atol=2e-5)
POINTS = dict(rtol=2e-3, atol=2e-4)
SOLVE_ATOL = 1e-4
SETTINGS = {"matching": {"use_simple": True, "dist_thresh": 1e6},
            "tracking": {"min_match_frac": 0.01}}
B, MICROBATCH = 4, 2


def _images(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (B, 48, 64, 3)).astype(np.float32)


def _inputs(encode, mono, stack) -> dict:
    """Keyframes and step features of one package, from the same images."""
    kf_imgs = _images(0)
    f, p = encode(kf_imgs * 2.0 - 1.0)
    monos = [mono(f[i], p[i]) for i in range(B)]
    out = dict(kf_feat=f, kf_pos=p, kf_X=stack([m[0] for m in monos]),
               kf_C=stack([m[1] for m in monos]), imgs=_images(3))
    for step in range(2):
        out[f"feat{step}"], out[f"pos{step}"] = encode(_images(1 + step) * 2.0 - 1.0)
    return out


def _jax_run(jm, inputs, mesh) -> dict:
    """serving_run's script on JAX's BatchTracker."""
    bt = JaxBatchTracker(jm, mesh=mesh, microbatch=MICROBATCH)
    bt.init_from_keyframes(inputs["kf_feat"], inputs["kf_pos"], inputs["kf_X"], inputs["kf_C"])
    out = {}
    for step in range(2):
        r = bt.resolve_stats(bt.step_async(inputs[f"feat{step}"], inputs[f"pos{step}"]))
        out[f"stats{step}"], out[f"tracked{step}"] = r["match_frac"], r["tracked"]
        out[f"poses{step}"] = np.asarray(r["poses"])
    sel = np.array([2, 1])
    bt.update_keyframes([1, 2], *(inputs[k][sel] for k in ("kf_feat", "kf_pos", "kf_X", "kf_C")))
    out["closed"] = bt.close_slot(3)
    bt.open_slot(3, *(inputs[k][0] for k in ("kf_feat", "kf_pos", "kf_X", "kf_C")))
    r = bt.resolve_stats(bt.step_images_async(jnp.asarray(inputs["imgs"])))
    out["stats_img"], out["tracked_img"] = r["match_frac"], r["tracked"]
    out["poses_img"] = np.asarray(r["poses"])
    for k in ("T_WC", "kf_X", "kf_C", "kf_N", "fr_X", "kf_T"):
        out[k] = np.asarray(getattr(bt.state, k))
    return out


def _solve_problems() -> dict:
    out = {}
    for mode, seed, permute in (("rays", 3, True), ("calib", 4, False)):
        rng = np.random.default_rng(seed)
        prob = make_graph_problem(rng, num_kf=4, h=6, w=8, num_edges=8, permute=permute)
        p = {k: np.asarray(prob[k]) for k in ("Xs", "Cs", "ii", "jj", "idx", "valid", "Q")}
        p.update(Twc0=np.asarray(perturb_poses(rng, prob["Twc_gt"], mag=0.02)),
                 edge_mask=np.ones(8, bool), free=np.arange(4) >= 1, img_size=(6, 8))
        if mode == "calib":
            p["K"] = np.asarray(prob["K"], np.float32)
        out[mode] = p
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with both_configs(SETTINGS):
        jm, tm = tiny_pair("linear")
        jin = _inputs(lambda x: jm.encode(jnp.asarray(x)), jm.mono, jnp.stack)
        tin = _inputs(lambda x: tm.encode(torch.from_numpy(x)), tm.mono, torch.stack)
        tin = {k: np.asarray(v) for k, v in tin.items()}
        jax_out = _jax_run(jm, jin, jax_make_mesh(4))
        plain = serving_run(tm, None, tin, MICROBATCH)
    state = {k: v.clone() for k, v in tm.net.state_dict().items()}
    problems = _solve_problems()
    work = tmp_path_factory.mktemp("ranks")
    four = spawn(serving_rank, 4, (state, SETTINGS, tin, 2, MICROBATCH, problems), device="cpu",
                 workdir=str(work / "four"))
    two = spawn(serving_rank, 2, (state, SETTINGS, tin, 2, MICROBATCH), device="cpu",
                workdir=str(work / "two"))
    return dict(jax=jax_out, plain=plain, four=four, two=two, problems=problems)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_serving(got: dict, want: dict):
    for k in ("stats0", "stats1", "stats_img", "poses0", "poses1", "poses_img", "closed",
              "T_WC", "kf_N", "kf_T"):
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **STATS, err_msg=k)
    for k in ("kf_X", "kf_C", "fr_X"):
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **POINTS, err_msg=k)
    for k in ("tracked0", "tracked1", "tracked_img"):
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


@pytest.mark.parametrize("layout", ["dp2xtp2", "tp2"])
def test_sharded_serving_matches_unsharded_and_jax(runs, layout):
    """Every rank returns the global results: the same on each rank, within
    the bands of the port unsharded and of JAX's BatchTracker(mesh=make_mesh(4))."""
    ranks = runs["four"] if layout == "dp2xtp2" else runs["two"]
    for r in ranks:
        _assert_serving(r["serving"], runs["plain"])
        _assert_serving(r["serving"], runs["jax"])
    assert runs["plain"]["tracked0"].any()


def test_tp_splits_heads_and_raises_on_dp_remainders(runs):
    """tp 2 leaves each rank one of the tiny encoder's two heads; at dp 2 a
    batch of 3 and an explicit microbatch of 3 raise (JAX's checks)."""
    assert [r["heads"] for r in runs["two"]] == [1, 1]
    assert [r["heads"] for r in runs["four"]] == [1] * 4
    for r in runs["four"]:
        assert r["odd_batch_raises"] and r["microbatch_raises"]


@pytest.mark.parametrize("mode", ["rays", "calib", "rays+bf16", "calib+bf16"])
def test_sharded_graph_solve_matches_jax(runs, mode):
    base, _, bf16 = mode.partition("+")
    p = runs["problems"][base]
    args = [jnp.asarray(p[k]) for k in ("Twc0", "Xs", "Cs", "ii", "jj", "idx", "valid", "Q",
                                         "edge_mask", "free")]
    want, _ = jax_graph(*args, mode=base, K_intr=jnp.asarray(p["K"]) if "K" in p else None,
                        img_size=p["img_size"], params=JaxGNParams(max_iter=10, pixel_border=1),
                        mesh=jax_make_mesh(4, tp=1),
                        variant="noconcat+bf16" if bf16 else "noconcat")
    for r in runs["four"]:
        got = r["solve"][mode]
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SOLVE_ATOL, rtol=0)
        assert r["solve"][f"{base}_odd_edges_raise"]


def test_factor_graph_pads_edges_to_dp(runs):
    """Three edges, six two-way, padded with two masked edges to a multiple of
    dp 4 (JAX rounds its bucket up the same way); the sharded solve equals
    the unsharded one within the band."""
    for r in runs["four"]:
        fg = r["solve"]["factor_graph"]
        assert fg["unsharded_edges"] == 6 and fg["sharded_edges"] == 8
        assert fg["sharded_mask"].tolist() == [True] * 6 + [False] * 2
        np.testing.assert_allclose(fg["sharded_T"].numpy(), fg["unsharded_T"].numpy(),
                                   atol=SOLVE_ATOL, rtol=0)
        assert not torch.equal(fg["unsharded_T"][1:],
                               torch.tensor(runs["problems"]["rays"]["Twc0"][1:]))
