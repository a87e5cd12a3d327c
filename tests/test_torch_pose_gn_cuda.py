"""The ray-distance pose Gauss-Newton kernel (csrc/pose_gn.cu, ops/pose_gn.py)
on an NVIDIA GPU (marked `cuda`: skipped without a card). This file imports
no JAX, so it also runs on a card machine without it, outside the
repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pose_gn_cuda.py

Well-posed problems: keyframe points on chip_smoke.py's smooth surface
(depth 1.6-2.4, focal 1.2 w), seen from a seeded Sim(3) pose with 1 mm of
noise, 5% outliers and 10% of the points switched off. Each case holds the
kernel to the plain loop (`_pose_gn_loop_rays_soa`) on the card, in f32
with full-precision matrix products, and to the plain loop in float64 on
the CPU:

* the kernel's pose error against float64 is at most twice the plain
  loop's on the card, plus 1e-6 (only the order of the f32 sums differs);
* its iteration count is the plain loop's (JAX's count), except where the
  plain loop's stopping test came within 1e-3 (relative) of its threshold;
* two solves are bit-equal;
* at the main path's sizes (196,608 and 84,672 points), a ragged size, one
  stream and eight, Huber and Tukey.

Then: a stream whose system is not positive definite (a negative damping
floor against a near-zero system) takes zero steps and leaves the other
streams of its batch bit-equal; the solve captured into a CUDA graph
replays with no host read; and a captured K = 8 tracking window launches
`pose_gn` 8 x (1 + max_iters) times and never runs the plain loop.
"""

import math

import numpy as np
import pytest
import torch

from mast3r_slam_torch.ops.pose_gn import REL_ERROR  # the loop's own relative-cost stop
from test_torch_window_graph_cuda import no_host_reads

VITL_N, DUNE_N, RAGGED_N = 196_608, 84_672, 100_003  # 512x384, 336x252, neither
NEAR = 1e-3  # a stopping quantity this close (relative) to its threshold may flip
SLACK = 1e-6  # the pose error the kernel may add beyond twice the plain loop's
SIGMA_RAY, SIGMA_DIST = 0.003, 10.0  # the tracker's defaults (config.py)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def problem(b: int, n: int, seed: int) -> tuple:
    """b streams of n points (numpy-seeded, float32 on the CPU):
    (T_init [b, 8], Xf [b, n, 3], rd_k [b, n, 4], sqrt_info [b, n, 4])."""
    from mast3r_slam_torch.lie import core as lie

    rng = np.random.default_rng(seed)
    w = 512
    h = -(-n // w)
    u = np.arange(w) / w * 2 * np.pi
    v = (np.arange(h) / h * 2 * np.pi)[:, None]
    p = rng.uniform(0, 2 * np.pi, (b, 4, 1, 1))
    z = (2.0 + 0.2 * np.sin(u + p[:, 0]) * np.cos(v + p[:, 1])
         + 0.2 * np.cos(2 * u + p[:, 2]) * np.sin(2 * v + p[:, 3]))  # [b, h, w]
    f = 1.2 * w
    uu, vv = np.arange(w) - w / 2, (np.arange(h) - h / 2)[:, None]
    Xk = np.stack([uu / f * z, vv / f * z, z], -1).reshape(b, h * w, 3)[:, :n]
    xi = rng.normal(size=(b, 7)) * ([5e-3] * 3 + [3e-3] * 3 + [3e-3])
    T_true = lie.sim3_exp(torch.from_numpy(xi))
    Xf = lie.sim3_act(lie.sim3_inv(T_true)[:, None], torch.from_numpy(Xk)).numpy()
    Xf = Xf + rng.normal(0, 1e-3, Xf.shape)
    bad = rng.uniform(size=(b, n)) < 0.05
    Xf[bad] += rng.normal(0, 0.2, (bad.sum(), 3))
    d = np.linalg.norm(Xk, axis=-1, keepdims=True)
    wgt = np.sqrt(rng.uniform(1.5, 3.0, (b, n, 1))) * (rng.uniform(size=(b, n, 1)) > 0.1)
    sqrt_info = np.concatenate([np.repeat(wgt / SIGMA_RAY, 3, -1), wgt / SIGMA_DIST], -1)
    T0 = lie.sim3_identity((b,), dtype=torch.float32)
    return tuple([T0] + [torch.from_numpy(a.astype(np.float32))
                         for a in (Xf, np.concatenate([Xk / d, d], -1), sqrt_info)])


def plain(T0, Xf, rd, w, p) -> dict:
    """The plain loop on the tensors' device and dtype, and the margin of each
    stream's deciding stopping tests: min over the tests it made before it
    stopped of |quantity / threshold - 1| (relative cost change and step
    norm), from the costs and steps its iterations computed."""
    from mast3r_slam_torch.ops import gauss_newton as gn

    seen = []
    iterate = gn._pose_gn_iterate

    def recording(solve_step, T_init, params, rel_error, count=False):
        def step(T):
            T_new, tau, cost = solve_step(T)
            seen.append((cost.double().cpu(), torch.linalg.vector_norm(tau, dim=-1).double().cpu()))
            return T_new, tau, cost
        return iterate(step, T_init, params, rel_error, count)

    gn._pose_gn_iterate = recording
    try:
        T, cost, iters = gn._pose_gn_loop_rays_soa(T0, Xf.mT, rd.mT, w.mT, p, count=True)
    finally:
        gn._pose_gn_iterate = iterate
    costs = torch.stack([c for c, _ in seen])  # [max_iter, b]
    steps = torch.stack([s for _, s in seen])
    margin = torch.full(costs.shape[1:], math.inf, dtype=torch.float64)
    for it in range(1, p.max_iter):
        old = costs[it - 2] if it >= 2 else torch.full_like(costs[0], math.inf)
        rel = (old - costs[it - 1]).abs() / (old + 1e-10)
        m = torch.minimum((rel / REL_ERROR - 1).abs().nan_to_num(math.inf),
                          (steps[it - 1] / p.delta_thresh - 1).abs())
        deciding = it <= iters.cpu()  # tests made while the stream still ran
        margin = torch.where(deciding, torch.minimum(margin, m), margin)
    return dict(T=T, cost=cost, iters=iters, margin=margin)


def _to(dev, tensors, dtype=torch.float32):
    return [t.to(dev, dtype) for t in tensors]


CASES = [(1, n, robust) for n in (VITL_N, DUNE_N, RAGGED_N) for robust in ("huber", "tukey")]
CASES += [(8, VITL_N, "huber"), (8, VITL_N, "tukey")]


@pytest.mark.cuda
@pytest.mark.parametrize("b, n, robust", CASES)
def test_kernel_against_the_plain_loop_and_float64(card, b, n, robust):
    from mast3r_slam_torch.ops import gauss_newton as gn
    from mast3r_slam_torch.ops import pose_gn

    p = gn.GNParams(robust=robust)
    cpu = problem(b, n, seed=n + b + len(robust))
    args = _to(card, cpu)
    before = pose_gn.pose_gn_rays.launches
    T, cost, iters = pose_gn.pose_gn_rays(*args, p)
    T2, cost2, iters2 = pose_gn.pose_gn_rays(*args, p)
    torch.cuda.synchronize()
    assert pose_gn.pose_gn_rays.launches - before == 2 * (1 + p.max_iter)
    assert torch.equal(T, T2) and torch.equal(cost, cost2) and torch.equal(iters, iters2)

    twin = plain(*args, p)
    ref = plain(*_to("cpu", cpu, torch.float64), p)
    err = (T.double().cpu() - ref["T"]).abs().amax(-1)
    err_twin = (twin["T"].double().cpu() - ref["T"]).abs().amax(-1)
    print(f"[pose_gn] b {b} n {n} {robust}: pose error vs float64 kernel "
          f"{err.max().item():.3e}, plain loop on the card {err_twin.max().item():.3e}; "
          f"iterations kernel {iters.tolist()} plain {twin['iters'].tolist()} float64 "
          f"{ref['iters'].tolist()}; stop margin {twin['margin'].min().item():.3e}")
    assert bool(torch.isfinite(T).all()) and bool((iters >= 1).all())
    assert bool((err <= 2 * err_twin + SLACK).all()), (err, err_twin)
    same = iters.cpu() == twin["iters"].cpu()
    assert bool((same | (twin["margin"] < NEAR)).all()), (iters, twin["iters"], twin["margin"])
    rel = (cost - twin["cost"]).abs() / twin["cost"].abs()
    assert bool((rel[same.to(card)] < 1e-4).all()), rel
    # the problem is well posed: every stream moved far from the identity
    assert bool(((T - args[0]).abs().amax(-1) > 1e-3).all())


@pytest.mark.cuda
def test_a_stream_that_is_not_positive_definite_takes_zero_steps(card):
    """reg = -1 against a stream whose whitening is scaled to 1e-6 (its H + reg
    I has a negative pivot), inside a batch of 8 well-posed streams."""
    from mast3r_slam_torch.ops import gauss_newton as gn
    from mast3r_slam_torch.ops import pose_gn

    p = gn.GNParams(reg=-1.0)
    T0, Xf, rd, w = _to(card, problem(8, DUNE_N, seed=7))
    bad = w.clone()
    bad[3] *= 1e-6
    T, cost, iters = pose_gn.pose_gn_rays(T0, Xf, rd, bad, p)
    T_good, cost_good, iters_good = pose_gn.pose_gn_rays(T0, Xf, rd, w, p)
    twin = plain(T0, Xf, rd, bad, p)
    others = [i for i in range(8) if i != 3]
    assert torch.equal(T[3], T0[3]) and int(iters[3]) == 1
    assert torch.equal(twin["T"][3], T0[3]) and int(twin["iters"][3]) == 1
    assert torch.equal(T[others], T_good[others]) and torch.equal(cost[others], cost_good[others])
    assert torch.equal(iters[others], iters_good[others])
    assert bool(((T[others] - T0[others]).abs().amax(-1) > 1e-3).all())


@pytest.mark.cuda
def test_the_solve_replays_in_a_graph_with_no_host_read(card):
    from mast3r_slam_torch.ops import gauss_newton as gn
    from mast3r_slam_torch.ops import pose_gn

    p = gn.GNParams()
    static = _to(card, problem(1, VITL_N, seed=11))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pose_gn.pose_gn_rays(*static, p)  # warm-up: the library loads
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = pose_gn.pose_gn_rays.launches
    with no_host_reads(), torch.cuda.graph(graph):
        out = pose_gn.pose_gn_rays(*static, p)
    assert pose_gn.pose_gn_rays.launches - before == 1 + p.max_iter
    for seed in (12, 13):
        fresh = _to(card, problem(1, VITL_N, seed=seed))
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        with no_host_reads():
            graph.replay()
        want = pose_gn.pose_gn_rays(*fresh, p)
        torch.cuda.synchronize()
        for got, ref in zip(out, want):
            assert torch.equal(got, ref)


@pytest.mark.cuda
def test_a_captured_window_solves_through_the_kernel(card, monkeypatch):
    from mast3r_slam_torch.config import Config, reset_config, set_config
    from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel
    from mast3r_slam_torch.ops import gauss_newton as gn
    from mast3r_slam_torch.tracker import FrameTracker
    from mast3r_slam_torch.workload import BENCH_SETTINGS, drift_frames

    loop = gn._pose_gn_loop_rays_soa

    def cpu_only(T_init, Xt, *args, **kwargs):
        assert not Xt.is_cuda, "the plain loop ran on the card"
        return loop(T_init, Xt, *args, **kwargs)

    monkeypatch.setattr(gn, "_pose_gn_loop_rays_soa", cpu_only)
    small = MASt3RConfig(enc_embed_dim=128, enc_depth=2, enc_num_heads=2, dec_embed_dim=128,
                         dec_depth=2, dec_num_heads=2, head_type="dpt", dtype=torch.bfloat16)
    model = MASt3RModel.create(cfg=small, resolution=64, seed=1, device="cuda")
    h, w = model.out_hw
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    cfg = set_config(Config.from_dict(BENCH_SETTINGS))
    k = cfg.runtime.sync_every
    imgs = torch.from_numpy(drift_frames(base, 2 * k, rng)).cuda()
    try:
        tracker = FrameTracker(model, cfg)
        tracker.init_keyframe(base)
        for j in range(2):
            tracker.sync_window(tracker.track_window(imgs[j * k:(j + 1) * k]))
    finally:
        reset_config()
    (graph,) = tracker.graphs.graphs.values()
    assert k == 8 and graph.launches["pose_gn"] == k * (1 + cfg.tracking.max_iters)
