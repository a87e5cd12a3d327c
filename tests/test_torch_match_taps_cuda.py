"""The dense matcher's kernel (csrc/match_taps.cu, ops/match_taps.py) on an
NVIDIA GPU (marked `cuda`: skipped without a card). This file imports no
JAX, so it also runs on a card machine without it, outside the repository's
conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_match_taps_cuda.py -s

Scenes: a smooth surface and the same view displaced by a few pixels with 1
mm of noise, smooth unit descriptors (tests/test_torch_match_taps.py
`scene`), the pointmaps and descriptors handed over as channel views of
wider tensors (the head's outputs are views). Each case holds the kernel to
the plain loop (`_match_dense_loop`) on the card and to a float64
recomputation of every tap's cost over the same bf16 streams
(`compare_to_plain`):

* its ray streams are bit-equal to the plain loop's;
* every pick is within 1e-5 of the float64 minimum over the lattice;
* idx equals the plain loop's on at least 99.9% of the pixels, and where it
  does not, the two picks' float64 costs are within 1e-5;
* where idx agrees, the payload equals the loop's, and valid too except
  where the distance is within 1e-6 (relative) of dist_thresh;
* hit is the scatter-max of the kernel's own valid over its own idx;
* the call without payload and hit gives the same idx and valid, and a
  repeated call is bit-equal;
* at the main path's shapes (1, 384, 512), (1, 252, 336), the serving batch
  (8, 384, 512) and an odd (2, 37, 53), over the deployment lattice (radius
  3, dilations (2, 1)) and the in-code default (radius 6, dilation 1), with
  the descriptors weighted 1.0 and 0.0.

Then: descriptors of 16 and 5 channels; NaN rows in every input; a
constant image, whose taps all tie, where idx equals the loop's at every
pixel; a spatially strided input against its copy; the call captured into a
CUDA graph replays with no host read and equals the eager call; and a
captured K = 8 tracking window launches the kernel 8 times and never runs
the plain loop.
"""

import numpy as np
import pytest
import torch

from test_torch_match_taps import compare_to_plain, scene, tap_costs64
from test_torch_window_graph_cuda import no_host_reads

SHAPES = [(1, 384, 512), (1, 252, 336), (8, 384, 512), (2, 37, 53)]
LATTICES = [(3, (2, 1)), (6, (1,))]
DIST = 0.002  # splits the pixels of these scenes: a correct match lies ~1.7 mm from its point


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def on_card(inputs: tuple, dev) -> tuple:
    """The scene on the card, X and D as channel views of wider tensors."""
    X11, X21, D11, D21, pay = inputs

    def view(t):
        wide = torch.zeros(*t.shape[:-1], t.shape[-1] + 2, device=dev)
        wide[..., 1:-1] = t.to(dev)
        return wide[..., 1:-1]

    return view(X11), view(X21), view(D11), view(D21), pay.to(dev)


def run_case(inputs, radius, dilations, desc_weight) -> dict:
    from mast3r_slam_torch.geometry import normalize_rays
    from mast3r_slam_torch.ops import match_taps
    from mast3r_slam_torch.ops.dense_match import _match_dense_loop

    X11, X21, D11, D21, pay = inputs
    kw = dict(radius=radius, dilations=dilations, desc_weight=desc_weight, dist_thresh=DIST)
    before = match_taps.match_taps.launches
    got = match_taps.match_taps(X11, X21, D11, D21, payload=pay, want_hit=True, **kw)
    again = match_taps.match_taps(X11, X21, D11, D21, payload=pay, want_hit=True, **kw)
    bare = match_taps.match_taps(X11, X21, D11, D21, **kw)
    want = _match_dense_loop(X11, X21, D11, D21, payload=pay, want_hit=True, **kw)
    torch.cuda.synchronize()
    assert match_taps.match_taps.launches - before == 3
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert len(bare) == 2 and torch.equal(bare[0], got[0]) and torch.equal(bare[1], got[1])
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.bool
    assert got[2].dtype == torch.bfloat16 and got[3].dtype == torch.bool
    for X in (X11, X21):  # bit for bit, NaN included
        rays, loops = match_taps.ray_stream(X), normalize_rays(X).to(torch.bfloat16)
        assert torch.equal(rays.view(torch.int16), loops.view(torch.int16))
    costs = tap_costs64(X11, X21, D11, D21, radius, dilations, desc_weight)
    return compare_to_plain(got, want, costs, inputs, radius, dilations, DIST, True, True)


@pytest.mark.cuda
@pytest.mark.parametrize("desc_weight", [1.0, 0.0])
@pytest.mark.parametrize("radius, dilations", LATTICES)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_against_the_plain_loop_and_float64(card, shape, radius, dilations, desc_weight):
    b, h, w = shape
    inputs = on_card(scene(b, h, w, seed=h + w + radius), card)
    figures = run_case(inputs, radius, dilations, desc_weight)
    print(f"[match_taps] {shape} r {radius} {dilations} w {desc_weight}: {figures}")
    assert 0.05 < figures["valid"] < 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 5])
def test_a_narrower_descriptor(card, d):
    """Fewer than 24 channels: the shared tile's chunks are zero beyond them."""
    figures = run_case(on_card(scene(2, 37, 53, seed=d, d=d), card), 3, (2, 1), 1.0)
    print(f"[match_taps] {d} channels: {figures}")


@pytest.mark.cuda
@pytest.mark.parametrize("radius, dilations", LATTICES)
def test_nan_rows(card, radius, dilations):
    X11, X21, D11, D21, pay = scene(2, 37, 53, seed=9)
    X11[0, 10], X21[0, 20], D11[1, 5], D21[1, 30] = (float("nan"),) * 4
    X21[1, 3, 7] = float("nan")
    inputs = on_card((X11, X21, D11, D21, pay), card)
    figures = run_case(inputs, radius, dilations, 1.0)
    from mast3r_slam_torch.ops import match_taps

    idx, valid = match_taps.match_taps(*inputs[:4], radius=radius, dilations=dilations,
                                       dist_thresh=DIST)
    w = 53
    row = torch.arange(20 * w, 21 * w, device=card)
    assert torch.equal(idx[0, 20 * w:21 * w], row) and not bool(valid[0, 20 * w:21 * w].any())
    assert not bool(((idx[0] // w) == 10).any())  # no NaN view-1 pixel wins
    print(f"[match_taps] NaN rows r {radius} {dilations}: {figures}")


@pytest.mark.cuda
@pytest.mark.parametrize("radius, dilations", LATTICES)
@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 384, 512)])
def test_a_constant_image_ties_everywhere_and_the_first_tap_wins(card, shape, radius, dilations):
    from mast3r_slam_torch.ops import match_taps
    from mast3r_slam_torch.ops.dense_match import _match_dense_loop, window_taps

    b, h, w = shape
    X = torch.tensor([0.1, -0.2, 2.0], device=card).expand(b, h, w, 3).contiguous()
    D = torch.full((b, h, w, 24), 24 ** -0.5, device=card)
    kw = dict(radius=radius, dilations=dilations, dist_thresh=DIST)
    got = match_taps.match_taps(X, X, D, D, **kw)
    want = _match_dense_loop(X, X, D, D, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the first tap of the lattice that lands in the image
    taps = window_taps(radius, dilations)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    first = np.full((h, w), -1)
    for du, dv in reversed(taps):
        inside = (xx + du >= 0) & (xx + du < w) & (yy + dv >= 0) & (yy + dv < h)
        first = np.where(inside, (yy + dv) * w + xx + du, first)
    assert np.array_equal(got[0][0].cpu().numpy(), first.reshape(-1))


@pytest.mark.cuda
def test_a_spatially_strided_input_matches_its_copy(card):
    from mast3r_slam_torch.ops import match_taps

    inputs = on_card(scene(2, 74, 106, seed=13), card)
    strided = tuple(t[:, ::2, ::2] for t in inputs)
    copies = tuple(t.contiguous() for t in strided)
    kw = dict(radius=3, dilations=(2, 1), dist_thresh=DIST, want_hit=True)
    got = match_taps.match_taps(*strided[:4], payload=strided[4], **kw)
    want = match_taps.match_taps(*copies[:4], payload=copies[4], **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_the_match_replays_in_a_graph_with_no_host_read(card):
    from mast3r_slam_torch.ops import match_taps

    kw = dict(radius=3, dilations=(2, 1), dist_thresh=DIST, want_hit=True)
    static = on_card(scene(1, 384, 512, seed=21), card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        match_taps.match_taps(*static[:4], payload=static[4], **kw)  # warm-up: the library loads
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = match_taps.match_taps.launches
    with no_host_reads(), torch.cuda.graph(graph):
        out = match_taps.match_taps(*static[:4], payload=static[4], **kw)
    assert match_taps.match_taps.launches - before == 1
    for seed in (22, 23):
        fresh = on_card(scene(1, 384, 512, seed=seed, shift=(seed % 5 - 2, 1)), card)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        with no_host_reads():
            graph.replay()
        want = match_taps.match_taps(*fresh[:4], payload=fresh[4], **kw)
        torch.cuda.synchronize()
        for got, ref in zip(out, want):
            assert torch.equal(got, ref)


@pytest.mark.cuda
def test_a_captured_window_matches_through_the_kernel(card, monkeypatch):
    from mast3r_slam_torch.config import Config, reset_config, set_config
    from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel
    from mast3r_slam_torch.ops import dense_match
    from mast3r_slam_torch.tracker import FrameTracker
    from mast3r_slam_torch.workload import BENCH_SETTINGS, drift_frames

    loop = dense_match._match_dense_loop

    def cpu_only(X11, *args, **kwargs):
        assert not X11.is_cuda, "the plain loop ran on the card"
        return loop(X11, *args, **kwargs)

    monkeypatch.setattr(dense_match, "_match_dense_loop", cpu_only)
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
    assert cfg.matching.method == "dense"
    assert k == 8 and graph.launches["match_taps"] == k
