"""The graph solve's "+bf16" variants (`local_opt.solve_variant`: the edge
transients in bf16, the 7x7 blocks and gradients summed in f32) against the
JAX package's, on tests/fixtures.py `make_graph_problem` worlds.

Bands:
* the port's bf16 solve against JAX's bf16 solve: POSE_ATOL 1e-5, the f32
  parity test's band (tests/test_torch_graph_gn.py); measured <= 1.2e-7;
* either bf16 solve against the f32 ones: 5e-2, tests/test_gauss_newton.py's
  band for bf16 against f32. These noise-free worlds converge to the same
  poses with either precision (measured <= 1.2e-7), so the solves alone do not
  tell f32 sums from bf16 ones: the blocks do;
* the blocks S and b of one edge pass against JAX's, relative to their
  largest entry: 1e-6 against "noconcat+bf16" (the same f32 sum order;
  measured <= 1.3e-8) and 1e-5 against "base+bf16" (JAX sums the concatenated
  [E, 7, 3N] rows in one contraction; measured <= 1.3e-6). A contraction
  summed in bf16 lands 1e-3 - 6e-3 away, and the f32 blocks 5e-4 - 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops.gauss_newton import GNParams as JaxGNParams
from mast3r_slam_tpu.ops.gauss_newton import _edge_system as jax_edge_system
from mast3r_slam_tpu.ops.gauss_newton import gauss_newton_graph as jax_graph
from mast3r_slam_torch.ops.gauss_newton import GNParams, _edge_system, gauss_newton_graph
from tests.fixtures import make_graph_problem, perturb_poses

POSE_ATOL = 1e-5
BF16_BAND = 5e-2
BLOCK_RTOL = {"noconcat+bf16": 1e-6, "base+bf16": 1e-5}


def _problem(seed, h=8, w=12):
    rng = np.random.default_rng(seed)
    prob = make_graph_problem(rng, num_kf=4, h=h, w=w, num_edges=8)
    prob["Twc0"] = perturb_poses(rng, prob["Twc_gt"], mag=0.03)
    E = prob["ii"].shape[0]
    prob["args"] = (prob["Twc0"], prob["Xs"], prob["Cs"], prob["ii"], prob["jj"], prob["idx"],
                    prob["valid"], prob["Q"], np.ones(E, bool), np.arange(4) >= 1)
    return prob


@pytest.mark.parametrize("mode", ["rays", "points"])
@pytest.mark.parametrize("variant", ["noconcat+bf16", "base+bf16"])
def test_bf16_solve_matches_jax(variant, mode):
    prob = _problem(0)
    jax_args = [jnp.asarray(a) for a in prob["args"]]
    t_args = [torch.from_numpy(np.array(a)) for a in prob["args"]]
    jp, tp = JaxGNParams(max_iter=8, delta_thresh=0.0), GNParams(max_iter=8, delta_thresh=0.0)
    j16, _ = jax_graph(*jax_args, mode=mode, params=jp, variant=variant)
    j32, _ = jax_graph(*jax_args, mode=mode, params=jp, variant="noconcat")
    t16, _ = gauss_newton_graph(*t_args, mode=mode, params=tp, variant=variant)
    t32, _ = gauss_newton_graph(*t_args, mode=mode, params=tp)
    assert bool(torch.isfinite(t16).all())
    # The solve moves the poses (by ~0.03) as JAX's does.
    assert float((t16 - t_args[0]).abs().max()) > 100 * POSE_ATOL
    np.testing.assert_allclose(t16.numpy(), np.asarray(j16), atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(t16.numpy(), np.asarray(j32), atol=BF16_BAND, rtol=BF16_BAND)
    np.testing.assert_allclose(t16.numpy(), t32.numpy(), atol=BF16_BAND, rtol=BF16_BAND)
    assert not torch.equal(t16, t32)  # the transients were rounded
    again, _ = gauss_newton_graph(*t_args, mode=mode, params=tp, variant=variant)
    assert torch.equal(again, t16)


def test_bf16_blocks_sum_in_f32():
    """S and b of one bf16 edge pass come out f32 and equal JAX's bf16 blocks
    (bf16 transients, f32 sums) within BLOCK_RTOL of their largest entry, in
    every mode; the f32 blocks lie well outside that band."""
    prob = _problem(1)
    T = torch.from_numpy(np.array(prob["Twc0"]))
    ii = torch.from_numpy(np.array(prob["ii"])).long()
    jj = torch.from_numpy(np.array(prob["jj"])).long()
    Xs = torch.from_numpy(np.array(prob["Xs"]))
    idx = torch.from_numpy(np.array(prob["idx"])).long()
    Xi = torch.gather(Xs[ii], 1, idx[..., None].expand(-1, -1, 3)).transpose(1, 2)
    Xj = Xs[jj].transpose(1, 2)
    Q = torch.from_numpy(np.array(prob["Q"]))
    mask = torch.ones_like(Q)
    K = torch.tensor([[10.0, 0.0, 6.0], [0.0, 10.0, 4.0], [0.0, 0.0, 1.0]])
    jax_in = [jnp.asarray(x.numpy()) for x in (T, Xi, Xj, ii.int(), jj.int(), mask, Q)]
    for mode in ("rays", "points", "calib"):
        K_intr, img = (K, (8, 12)) if mode == "calib" else (None, None)
        jK = None if K_intr is None else jnp.asarray(K_intr.numpy())
        S16, b16, _ = _edge_system(T, Xi, Xj, ii, jj, mask, Q, mode, K_intr, img, GNParams(),
                                   bf16=True)
        S32, b32, _ = _edge_system(T, Xi, Xj, ii, jj, mask, Q, mode, K_intr, img, GNParams())
        assert S16.dtype == torch.float32 and b16.dtype == torch.float32
        for variant, rtol in BLOCK_RTOL.items():
            jS, jb, _ = jax_edge_system(*jax_in, mode, jK, img, JaxGNParams(), variant=variant)
            jS, jb = np.asarray(jS), np.asarray(jb)
            for got, ref, f32 in ((S16, jS, S32), (b16, jb, b32)):
                scale = np.abs(ref).max()
                assert scale > 0, (mode, variant)
                gap = np.abs(got.numpy() - ref).max() / scale
                assert gap <= rtol, (mode, variant, gap)
                assert np.abs(f32.numpy() - ref).max() / scale > 10 * rtol, (mode, variant)
