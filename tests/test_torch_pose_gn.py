"""The ray-distance pose Gauss-Newton kernel's wrapper (ops/pose_gn.py) on the
CPU: its build registration, its launch counter in the window graph's
arithmetic, the route a CPU tensor takes (the plain loop, which the JAX
comparisons in tests/test_torch_gauss_newton.py and test_torch_serving.py
hold), and the launch geometry and stream layout it hands the kernel. The
kernel itself runs only on a card: tests/test_torch_pose_gn_cuda.py.
"""

import numpy as np
import pytest
import torch

from mast3r_slam_torch import graphs
from mast3r_slam_torch.lie import core as lie
from mast3r_slam_torch.ops import build, pose_gn
from mast3r_slam_torch.ops import gauss_newton as gn


def _problem(b, n, seed=0):
    """b streams of n points: a pose near the identity, noisy frame points."""
    rng = np.random.default_rng(seed)
    Xk = torch.from_numpy((rng.normal(size=(b, n, 3)) * [1.0, 0.7, 0.5] + [0, 0, 3]).astype(
        np.float32))
    xi = torch.from_numpy((rng.normal(size=(b, 7)) * 0.03).astype(np.float32))
    Xf = lie.sim3_act(lie.sim3_inv(lie.sim3_exp(xi))[:, None], Xk)
    Xf = Xf + torch.from_numpy(rng.normal(0, 1e-3, Xf.shape).astype(np.float32))
    d = Xk.norm(dim=-1, keepdim=True)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (b, n, 1)).astype(np.float32))
    sqrt_info = torch.cat([(w / 0.003).expand(b, n, 3), w / 10.0], -1)
    return lie.sim3_identity((b,)), Xf, torch.cat([Xk / d, d], -1), sqrt_info


def test_pose_gn_is_built_with_the_other_kernels():
    assert "pose_gn" in build.KERNEL_SOURCES
    src, cmd, out = build._target("pose_gn")
    assert src == build.CSRC / "pose_gn.cu" and src.exists()
    assert cmd[0] == "nvcc" and "arch=compute_90a,code=sm_90a" in cmd
    assert out.parent == build.BUILD_DIR and out.name.startswith("libpose_gn-")
    text = src.read_text()
    for symbol in ("pose_gn_init", "pose_gn_iterate"):
        assert f'extern "C" int {symbol}(' in text
    # the constants the wrapper sizes the state and the partials with
    for name, value in (("kThreads", pose_gn.THREADS), ("kSums", pose_gn.SUMS),
                        ("kState", pose_gn.STATE), ("kIState", pose_gn.ISTATE)):
        assert f"constexpr int {name} = {value};" in text


def test_launch_counter_round_trips_through_the_window_arithmetic():
    before = graphs.launch_counts()
    assert before["pose_gn"] == pose_gn.pose_gn_rays.launches
    # a captured K = 8 window: one setup and max_iter iteration launches a frame
    graphs.add_launches({"pose_gn": 1 + gn.GNParams().max_iter}, 8)
    delta = graphs.launch_delta(before, graphs.launch_counts())
    assert delta == {"pose_gn": 8 * (1 + gn.GNParams().max_iter)}
    assert pose_gn.pose_gn_rays.launches == before["pose_gn"] + delta["pose_gn"]
    graphs.add_launches(graphs.launch_delta(graphs.launch_counts(), before))  # taken back
    assert graphs.launch_counts() == before


@pytest.mark.parametrize("b", [None, 3])
def test_cpu_tensors_take_the_plain_loop(monkeypatch, b):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU solve reached the kernel's wrapper")

    monkeypatch.setattr(pose_gn, "pose_gn_rays", refuse)
    T0, Xf, rd, w = _problem(b or 1, 500)
    if b is None:
        T0, Xf, rd, w = T0[0], Xf[0], rd[0], w[0]
    p = gn.GNParams(max_iter=6)
    T, cost = gn.gauss_newton_pose_rays(T0, Xf, rd, w, p)
    T_plain, cost_plain, iters = gn._pose_gn_loop_rays_soa(T0, Xf.mT, rd.mT, w.mT, p, count=True)
    assert torch.equal(T, T_plain) and torch.equal(cost, cost_plain)
    assert T.shape == T0.shape and cost.shape == T0.shape[:-1]
    assert iters.dtype == torch.int32 and bool(((iters >= 1) & (iters <= 6)).all())
    assert gn._pose_gn_loop_rays_soa(T0, Xf.mT, rd.mT, w.mT, p)[2] is None


def test_the_wrapper_takes_float32_cuda_tensors_only():
    T0, Xf, rd, w = _problem(1, 64)
    with pytest.raises(TypeError, match="float32 CUDA"):
        pose_gn.pose_gn_rays(T0, Xf, rd, w, gn.GNParams())
    with pytest.raises(ValueError, match="shapes"):
        pose_gn.pose_gn_rays(T0, Xf, rd[..., :3], w, gn.GNParams())
    with pytest.raises(ValueError, match="robust"):
        pose_gn.pose_gn_rays(T0, Xf, rd, w, gn.GNParams(robust="cauchy"))


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 84_672, 100_003, 196_608])
def test_the_grid_walk_covers_every_point_once(n):
    blocks = pose_gn.pose_gn_blocks(n)
    assert 1 <= blocks <= pose_gn.MAX_BLOCKS
    assert blocks == pose_gn.MAX_BLOCKS or blocks * pose_gn.THREADS >= n
    # csrc/pose_gn.cu: thread (block, tid) takes block * THREADS + tid + j * blocks * THREADS
    first = np.arange(blocks * pose_gn.THREADS)
    seen = np.concatenate([first + j * first.size for j in range(-(-n // first.size))] or [[]])
    seen = seen[seen < n]
    assert np.array_equal(np.sort(seen), np.arange(n))


def test_streams_are_views_of_the_callers_tensors():
    """The matcher's payload [b, N, 5] is read in place through its [..., 2:5]
    view, a batch broadcasts with stride 0, and no batch is one stream."""
    pay = torch.randn(2, 10, 5)
    X = pose_gn._streams(pay[..., 2:5], torch.Size([2]))
    assert X.data_ptr() == pay[..., 2:5].data_ptr() and X.stride() == (50, 5, 1)
    one = pose_gn._streams(pay[0, :, 2:5], torch.Size([]))
    assert one.shape == (1, 10, 3) and one.data_ptr() == pay[0, :, 2:5].data_ptr()
    shared = pose_gn._streams(pay[0, :, 2:5], torch.Size([4]))
    assert shared.shape == (4, 10, 3) and shared.stride()[0] == 0
    nested = pose_gn._streams(pay[..., 2:5], torch.Size([3, 2]))
    assert nested.shape == (6, 10, 3) and torch.equal(nested[5], pay[1, :, 2:5])
    T = pose_gn._streams(lie.sim3_identity()[None, :], torch.Size([]))[:, 0]
    assert T.shape == (1, 8)
