"""The dense matcher's kernel wrapper (ops/match_taps.py) on the CPU: its tap
table, its build registration, its launch counter in the window graph's
arithmetic, the route a CPU tensor takes (the plain loop, which
tests/test_torch_match.py holds to JAX), what the wrapper refuses, and the
float64 checker that the card tests hold the kernel to, run here on the
plain loop. The kernel itself runs only on a card:
tests/test_torch_match_taps_cuda.py, which imports this file's helpers
(this file imports no JAX).
"""

import numpy as np
import pytest
import torch

from mast3r_slam_torch import graphs
from mast3r_slam_torch.ops import build, dense_match, match_taps
from mast3r_slam_torch.ops.dense_match import _match_dense_loop, match_dense_window, window_taps

PICK_ATOL = 1e-5  # a pick's float64 cost above the lattice's float64 minimum (f32 sum-order noise)
AGREE = 0.999  # idx equal to the plain loop's on at least this share of pixels
DIST_RTOL = 1e-6  # valid may differ where |X11[idx] - X21| is this close (relative) to dist_thresh


def scene(b: int, h: int, w: int, seed: int, shift=(3, -2), noise: float = 1e-3,
          d: int = 24) -> tuple:
    """b views of a smooth surface and the same views displaced by `shift`
    pixels with noise, smooth unit descriptor fields of d channels, a
    payload of 5 channels: (X11, X21, D11, D21, payload) [b, h, w, *] float32
    on the CPU."""
    rng = np.random.default_rng(seed)

    def smooth(c, cell=8):
        coarse = rng.normal(size=(b, c, h // cell + 2, w // cell + 2)).astype(np.float32)
        up = torch.nn.functional.interpolate(torch.from_numpy(coarse), scale_factor=cell,
                                             mode="bilinear", align_corners=False)
        return up[:, :, :h, :w].permute(0, 2, 3, 1)

    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    z = 2.0 + 0.3 * torch.sin(uu / 9.0) * torch.cos(vv / 7.0) + 0.05 * smooth(1)[..., 0]
    f = 0.8 * w
    X11 = torch.stack([(uu - w / 2) / f * z, (vv - h / 2) / f * z, z], -1)
    du, dv = shift
    X21 = torch.roll(X11, (dv, du), dims=(1, 2))
    X21 = X21 + torch.from_numpy(rng.normal(0, noise, X21.shape).astype(np.float32))
    D11 = smooth(d)
    D11 = D11 / D11.norm(dim=-1, keepdim=True)
    D21 = torch.roll(D11, (dv, du), dims=(1, 2))
    D21 = D21 + torch.from_numpy(rng.normal(0, 0.05, D21.shape).astype(np.float32))
    D21 = D21 / D21.norm(dim=-1, keepdim=True)
    payload = torch.from_numpy(rng.normal(size=(b, h, w, 5)).astype(np.float32))
    return X11, X21, D11, D21, payload


def tap_costs64(X11, X21, D11, D21, radius, dilations, desc_weight) -> torch.Tensor:
    """[T, B, H, W] float64 cost of every tap in `window_taps` order over the
    bf16 streams (the rays from `match_taps.ray_stream` on the inputs'
    device), inf outside the image and where the cost is NaN."""
    taps = window_taps(radius, tuple(dilations))
    r = max(max(abs(du), abs(dv)) for du, dv in taps)
    b, h, w, _ = X11.shape
    bf16, nan = torch.bfloat16, float("nan")
    r1 = match_taps.ray_stream(X11).double()
    r2 = match_taps.ray_stream(X21).double()
    d1, d2 = D11.to(bf16).double(), D21.to(bf16).double()

    def pad(x):  # out of the image: NaN, then inf
        out = x.new_full((b, h + 2 * r, w + 2 * r, x.shape[-1]), nan)
        out[:, r:r + h, r:r + w] = x
        return out

    r1, d1 = pad(r1), pad(d1)
    costs = []
    for du, dv in taps:
        ys, xs = slice(r + dv, r + dv + h), slice(r + du, r + du + w)
        cost = ((r1[:, ys, xs] - r2) ** 2).sum(-1)
        if desc_weight > 0:
            cost = cost - desc_weight * (d1[:, ys, xs] * d2).sum(-1)
        costs.append(torch.where(torch.isnan(cost), float("inf"), cost))
    return torch.stack(costs)


def picked_costs(costs: torch.Tensor, idx: torch.Tensor, radius, dilations) -> torch.Tensor:
    """[B, H, W] float64 cost of the tap each pixel's idx [B, H*W] names (on
    the costs' device)."""
    taps = window_taps(radius, tuple(dilations))
    r = max(max(abs(du), abs(dv)) for du, dv in taps)
    side = 2 * r + 1
    table = torch.full((side * side,), -1, dtype=torch.int64)
    for t, (du, dv) in enumerate(taps):
        table[(dv + r) * side + du + r] = t
    _, b, h, w = costs.shape
    idx = idx.reshape(b, h, w).to(costs.device)
    yy = torch.arange(h, device=costs.device)[:, None]
    xx = torch.arange(w, device=costs.device)
    du, dv = idx % w - xx, idx // w - yy
    assert bool(((du.abs() <= r) & (dv.abs() <= r)).all()), "a pick outside the lattice's reach"
    t = table.to(costs.device)[(dv + r) * side + du + r]
    assert bool((t >= 0).all()), "a pick that is no tap of the lattice"
    return torch.gather(costs, 0, t[None])[0]


def pick_gap(costs: torch.Tensor, idx: torch.Tensor, radius, dilations) -> float:
    """The largest amount by which a pick's float64 cost exceeds the float64
    minimum over the lattice (0 where no tap has a finite cost and the pick
    none either; inf where a pick is infinite though a finite tap exists)."""
    picked = picked_costs(costs, idx, radius, dilations)
    least = costs.min(0).values
    gap = torch.where(torch.isinf(least) & torch.isinf(picked), 0.0, picked - least)
    return gap.max().item()


def compare_to_plain(got: tuple, want: tuple, costs: torch.Tensor, inputs: tuple, radius,
                     dilations, dist_thresh, payload: bool, hit: bool) -> dict:
    """Hold `got` (idx, valid, then pay_g and hit where `payload` and `hit`
    say) to the plain loop's `want` over the same inputs: idx equal on at
    least AGREE of the pixels and, where not, the two picks' float64 costs
    within PICK_ATOL; every pick within PICK_ATOL of the float64 minimum;
    where idx agrees, pay_g equal and valid equal except where the float64
    distance is within DIST_RTOL of dist_thresh; hit the scatter-max of got's
    own valid over its own idx. Returns the figures."""
    X11, X21 = inputs[:2]
    b = X11.shape[0]
    idx, valid = got[0], got[1]
    agree = idx == want[0]
    out = dict(agree=agree.double().mean().item(), gap=pick_gap(costs, idx, radius, dilations))
    assert out["agree"] >= AGREE and out["gap"] <= PICK_ATOL, out
    if not bool(agree.all()):
        a = picked_costs(costs, idx, radius, dilations).reshape(b, -1)
        c = picked_costs(costs, want[0], radius, dilations).reshape(b, -1)
        out["tie_gap"] = (a - c).abs()[~agree].max().item()
        assert out["tie_gap"] <= PICK_ATOL, out
    Xm = torch.gather(X11.reshape(b, -1, 3).double(), 1, idx[..., None].expand(b, -1, 3))
    dist = (Xm - X21.reshape(b, -1, 3).double()).norm(dim=-1)
    flip = (valid[..., 0] != want[1][..., 0]) & agree
    near = (dist - dist_thresh).abs() <= DIST_RTOL * dist_thresh
    out["valid_flips"] = int(flip.sum())
    assert not bool((flip & ~near).any()), out
    out["valid"] = valid.double().mean().item()
    if payload:
        assert torch.equal(got[2][agree], want[2][agree])
    if hit:
        own = torch.zeros(idx.shape, device=idx.device).scatter_reduce(
            1, idx, valid[..., 0].float(), reduce="amax") > 0.5
        assert torch.equal(got[-1], own)
    return out


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("radius, dilations, count", [(3, (2, 1), 89), (6, (1,), 169)])
def test_the_host_tap_table_is_window_taps_in_order(radius, dilations, count):
    du, dv = match_taps.tap_table(radius, dilations)
    assert list(zip(du, dv)) == window_taps(radius, dilations)
    assert len(du) == count and (du[0], dv[0]) == (-radius * dilations[0],) * 2
    reach = max(map(abs, du + dv))
    assert reach == 6 and all(-127 <= v <= 127 for v in du + dv)
    # view 1's tile and its halo at the deployment lattice: 44 x 20 pixels of 56 bytes
    assert match_taps.shared_bytes(reach, 3) == 44 * 20 * 56 <= match_taps.SHARED_LIMIT


def test_match_taps_is_built_with_the_other_kernels():
    assert "match_taps" in build.KERNEL_SOURCES
    src, cmd, out = build._target("match_taps")
    assert src == build.CSRC / "match_taps.cu" and src.exists()
    assert cmd[0] == "nvcc" and "arch=compute_90a,code=sm_90a" in cmd
    assert out.parent == build.BUILD_DIR and out.name.startswith("libmatch_taps-")
    text = src.read_text()
    assert 'extern "C" int match_taps(' in text
    for name, value in (("kTileW", match_taps.TILE_W), ("kTileH", match_taps.TILE_H),
                        ("kMaxTaps", match_taps.MAX_TAPS), ("kChunks", match_taps.CHUNKS),
                        ("kMaxShared", match_taps.SHARED_LIMIT)):
        assert f"constexpr int {name} = {value};" in text


def test_launch_counter_round_trips_through_the_window_arithmetic():
    before = graphs.launch_counts()
    assert before["match_taps"] == match_taps.match_taps.launches
    graphs.add_launches({"match_taps": 1}, 8)  # a captured K = 8 window: one match a frame
    delta = graphs.launch_delta(before, graphs.launch_counts())
    assert delta == {"match_taps": 8}
    assert match_taps.match_taps.launches == before["match_taps"] + 8
    graphs.add_launches(graphs.launch_delta(graphs.launch_counts(), before))  # taken back
    assert graphs.launch_counts() == before


@pytest.mark.parametrize("payload, want_hit, desc_weight", [(True, True, 1.0), (False, False, 0.0),
                                                            (True, False, 0.5)])
def test_cpu_tensors_take_the_plain_loop(monkeypatch, payload, want_hit, desc_weight):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU match reached the kernel's wrapper")

    monkeypatch.setattr(dense_match, "match_taps", refuse)
    X11, X21, D11, D21, pay = scene(2, 24, 40, seed=3)
    kw = dict(radius=3, dilations=(2, 1), desc_weight=desc_weight, dist_thresh=0.01,
              payload=pay if payload else None, want_hit=want_hit)
    got = match_dense_window(X11, X21, D11, D21, **kw)
    want = _match_dense_loop(X11, X21, D11, D21, **kw)
    assert len(got) == 2 + payload + want_hit
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].dtype == torch.int64 and got[1].shape == (2, 24 * 40, 1)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    X11, X21, D11, D21, pay = scene(1, 16, 24, seed=4)
    with pytest.raises(TypeError, match="float32 CUDA"):
        match_taps.match_taps(X11, X21, D11, D21)
    with pytest.raises(TypeError, match="float32 CUDA"):
        match_taps.match_taps(X11.double(), X21.double(), D11.double(), D21.double())
    with pytest.raises(ValueError, match="shapes"):
        match_taps.match_taps(X11, X21[:, :8], D11, D21)
    with pytest.raises(ValueError, match="shapes"):
        match_taps.match_taps(X11, X21, D11, D21[..., :16])
    with pytest.raises(ValueError, match="shapes"):
        match_taps.match_taps(X11, X21, D11, D21, payload=pay[:, :, :5])
    with pytest.raises(ValueError, match="taps"):
        match_taps.tap_table(12, (1,))  # 625 taps
    with pytest.raises(ValueError, match="channels"):
        match_taps.match_taps(X11, X21, torch.ones(1, 16, 24, 25), torch.ones(1, 16, 24, 25))


@pytest.mark.parametrize("radius, dilations, desc_weight", [(3, (2, 1), 1.0), (6, (1,), 0.0)])
def test_the_float64_checker_holds_the_plain_loop(radius, dilations, desc_weight):
    inputs = scene(2, 20, 36, seed=5, shift=(2, 3))
    X11, X21, D11, D21, pay = inputs
    # NaN rows in both views: no tap of a NaN view-2 row is taken, no NaN view-1 pixel wins
    X11[0, 4] = float("nan")
    X21[1, 7] = float("nan")
    kw = dict(radius=radius, dilations=dilations, desc_weight=desc_weight, dist_thresh=0.002)
    got = _match_dense_loop(X11, X21, D11, D21, payload=pay, want_hit=True, **kw)
    costs = tap_costs64(X11, X21, D11, D21, radius, dilations, desc_weight)
    assert pick_gap(costs, got[0], radius, dilations) <= PICK_ATOL
    figures = compare_to_plain(got, got, costs, inputs, radius, dilations, 0.002, True, True)
    assert figures["agree"] == 1.0 and 0.05 < figures["valid"] < 0.95
    w = X11.shape[2]
    nan_row = got[0][1].reshape(20, 36)[7]
    assert torch.equal(nan_row, torch.arange(7 * w, 8 * w))
    assert not bool(got[1][1, 7 * w:8 * w].any())
    assert not bool(((got[0][0] // w) == 4).any())
    # a pick one tap away from the minimum is caught
    idx = got[0].clone()
    idx[0, 5 * w + 10] += 1
    assert pick_gap(costs, idx, radius, dilations) > PICK_ATOL


def test_the_launch_hands_the_kernel_its_arguments_in_order(monkeypatch):
    """`_launch` against the C interface (csrc/match_taps.cu `match_taps`):
    the sizes, the tap table, the 7 input pointers and their 4 strides each
    (zeros for a missing payload), then the 4 output pointers."""
    seen = {}

    class Lib:
        def match_taps(self, *args):
            seen["args"] = args
            return 0

    class Stream:
        cuda_stream = 77

    monkeypatch.setattr(match_taps, "_lib", Lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    X11, X21, D11, D21, _ = scene(2, 10, 12, seed=6)
    D11 = torch.zeros(2, 10, 12, 26)[..., 1:-1]  # a channel view: strides (3120, 312, 26, 1)
    rays = (match_taps.ray_stream(X11), match_taps.ray_stream(X21))
    inputs = (X11, X21, D11, D21, None, *rays)
    outputs = (torch.empty(2, 120, dtype=torch.int64), torch.empty(2, 120, 1, dtype=torch.bool),
               None, torch.zeros(2, 120, dtype=torch.bool))
    du, dv = match_taps.tap_table(3, (2, 1))
    match_taps._launch(inputs, outputs, du, dv, 3, 1.0, 0.05)
    args = seen["args"]
    assert args[:8] == (77, 2, 10, 12, 24, 0, 3, 89)
    assert list(args[8]) == list(du) and list(args[9]) == list(dv)
    assert args[10:12] == (1.0, 0.05)
    assert list(args[12]) == [None if t is None else t.data_ptr() for t in inputs]
    assert list(args[13]) == [s for t in inputs for s in ((0,) * 4 if t is None else t.stride())]
    assert list(args[13])[8:12] == [3120, 312, 26, 1]
    assert list(args[14:]) == [None if t is None else t.data_ptr() for t in outputs]
