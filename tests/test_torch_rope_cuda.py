"""The RoPE kernel (csrc/rope.cu, ops/rope.py) on an NVIDIA GPU (marked
`cuda`: skipped without a card). This file imports no JAX, so it also runs
on a card machine without it, outside the repository's conftest (which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_rope_cuda.py -s

* At the paths' shapes (vitl's encoder (1, 16, 768, 64) and decoders (1, 12,
  768, 64), dune's (1, 12, 432, 64), serving's encoder (8, 16, 768, 64), and
  the sp 2 shards (1, 16, 384, 64) whose tables are a slice of 768
  positions), as self-attention (q and k strided views of one qkv tensor,
  one table) and as cross-attention (two projections, two tables): the
  kernel's q and k are bit-equal to ``apply_rope(x, cos, sin).to(bf16)`` on
  the card and on the CPU, contiguous, one launch a call; extreme values
  too.
* The route: f32 tensors and a head dim other than 64 raise on the card; a
  call that records a gradient launches the kernel forward and backward,
  the gradients bit-equal to autograd's through the plain rotation; a
  captured call replays with no host read and equals the eager call.
* A K = 8 window of phase 5's small bf16 model (chip_smoke.py) replayed with
  the kernel and again with `models.vit`'s rotation patched to the plain
  version: rows, poses and pointmaps bit-equal; `rope.launches` equals
  `flash_attention.launches` over the first, and is 0 over the second.
"""

import numpy as np
import pytest
import torch

from test_torch_window_graph_cuda import dispatch, no_host_reads, stacked

# (B, H, S, patch grid of the table's positions, first position of the shard)
SHAPES = {
    "vitl enc": (1, 16, 768, (24, 32), 0),
    "vitl dec": (1, 12, 768, (24, 32), 0),
    "dune": (1, 12, 432, (18, 24), 0),
    "serving": (8, 16, 768, (24, 32), 0),
    "sp2 rank 0": (1, 16, 384, (24, 32), 0),
    "sp2 rank 1": (1, 16, 384, (24, 32), 384),
}
K = 8


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def tables(b: int, grid: tuple, lo: int, s: int, dev, shift: int = 0):
    """The model's f32 (cos, sin) over a patch grid, positions lo .. lo + s
    (a slice of the whole table, as the sp shard takes it)."""
    from mast3r_slam_torch.models.vit import rope_2d_angles

    yy, xx = torch.meshgrid(torch.arange(grid[0], device=dev),
                            torch.arange(grid[1], device=dev), indexing="ij")
    pos = torch.stack([xx.reshape(-1) + shift, yy.reshape(-1)], -1).to(torch.int32)
    cos, sin = rope_2d_angles(pos[None].expand(b, -1, -1), 64)
    return cos[:, lo:lo + s], sin[:, lo:lo + s]


def operands(kind: str, b: int, h: int, s: int, dev, seed: int):
    """q and k as the model hands them over: self-attention's views of one
    qkv [B, S, 3, H, 64], or cross-attention's two [B, S, H * 64]
    projections split into heads."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "self":
        qkv = torch.randn(b, s, 3, h, 64, device=dev, generator=g).to(torch.bfloat16)
        q, k, _ = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        return q, k
    q, k = (torch.randn(b, s, h * 64, device=dev, generator=g).to(torch.bfloat16)
            .view(b, s, h, 64).transpose(1, 2) for _ in range(2))
    return q, k


def plain(x, cos, sin):
    from mast3r_slam_torch.ops.rope import apply_rope

    return apply_rope(x, cos, sin).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["self", "cross"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernel_is_bit_equal_to_the_plain_rotation(card, shape, kind):
    from mast3r_slam_torch.ops import rope

    b, h, s, grid, lo = SHAPES[shape]
    q, k = operands(kind, b, h, s, card, seed=len(shape))
    t_q = tables(b, grid, lo, s, card)
    t_k = t_q if kind == "self" else tables(1, grid, lo, s, card, shift=3)  # k: its own table
    before = rope.rope.launches
    got_q, got_k = rope.rotate_qk(q, k, t_q, t_k)
    assert rope.rope.launches == before + 1
    for got, x, t in ((got_q, q, t_q), (got_k, k, t_k)):
        assert got.dtype == torch.bfloat16 and got.shape == x.shape and got.is_contiguous()
        assert torch.equal(got, plain(x, *t))
        assert torch.equal(got.cpu(), plain(x.cpu(), *(c.cpu() for c in t)))
    again = rope.rotate_qk(q, k, t_q, t_k)
    assert all(torch.equal(a, g) for a, g in zip(again, (got_q, got_k)))


@pytest.mark.cuda
def test_extreme_values_and_one_table(card):
    from mast3r_slam_torch.ops import rope

    q, k = operands("self", 2, 3, 37, card, seed=9)  # a ragged last tile of positions
    specials = torch.tensor([0.0, -0.0, 3.0e38, -3.0e38, float("inf"), float("-inf"), 1e-40,
                             -1e-40], device=card).to(torch.bfloat16)
    q[0, 1, :8] = specials[torch.randperm(8, device=card)].repeat(8, 8)[:8, :64]
    k[1, :, 5, 16:24] = specials
    cos, sin = tables(1, (5, 8), 0, 37, card)
    got_q, got_k = rope.rotate_qk(q, k, (cos, sin), (cos, sin))
    for got, x in ((got_q, q), (got_k, k)):
        assert torch.equal(got.isnan(), plain(x, cos, sin).isnan())
        same = ~got.isnan()
        assert torch.equal(got[same], plain(x, cos, sin)[same])
    only_q = rope.rotate_qk(q, k, (cos, sin), None)  # NaN too: compared bit for bit
    assert torch.equal(only_q[0].view(torch.int16), got_q.view(torch.int16)) and only_q[1] is k


@pytest.mark.cuda
def test_the_card_takes_bf16_of_head_dim_64_or_raises(card):
    from mast3r_slam_torch.ops import rope

    q, k = operands("self", 1, 12, 432, card, seed=11)
    t = tables(1, (18, 24), 0, 432, card)
    before = rope.rope.launches
    with pytest.raises(TypeError, match="bf16 CUDA"):
        rope.rotate_qk(q.float(), k.float(), t, t)
    half = tuple(x[..., :32] for x in t)
    with pytest.raises(ValueError, match="takes \\[B, H, S, 64\\]"):
        rope.rotate_qk(q[..., :32], k[..., :32], half, half)
    assert rope.rope.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["self", "cross"])
@pytest.mark.parametrize("shape", ["vitl dec", "dune", "sp2 rank 1"])
def test_a_gradient_goes_through_the_kernel_bit_equal_to_the_plain_gradient(card, shape, kind):
    """A call that records a gradient: one launch forward and one backward
    (`backward_tables`), the output and the gradients of q and k bit-equal to
    autograd's through the plain rotation; a cotangent laid out as the
    attention backward's dq and dk ([B, S, H, 64] in memory) is read in
    place."""
    from mast3r_slam_torch.ops import rope

    b, h, s, grid, lo = SHAPES[shape]
    q, k = operands(kind, b, h, s, card, seed=11 + len(shape))
    t_q = tables(b, grid, lo, s, card)
    t_k = t_q if kind == "self" else tables(1, grid, lo, s, card, shift=3)
    q1, k1 = (x.detach().clone().requires_grad_() for x in (q, k))
    q2, k2 = (x.detach().clone().requires_grad_() for x in (q, k))
    before = rope.rope.launches
    rq, rk = rope.rotate_qk(q1, k1, t_q, t_k)
    assert rope.rope.launches == before + 1 and rq.requires_grad and rk.requires_grad
    g = torch.Generator(device=card).manual_seed(12)
    dq, dk = (torch.randn(b, s, h, 64, device=card, generator=g).to(torch.bfloat16)
              .transpose(1, 2) for _ in range(2))
    torch.autograd.backward((rq, rk), (dq, dk))
    assert rope.rope.launches == before + 2
    want_q, want_k = plain(q2, *t_q), plain(k2, *t_k)
    torch.autograd.backward((want_q, want_k), (dq, dk))
    assert torch.equal(rq, want_q) and torch.equal(rk, want_k)
    assert torch.equal(q1.grad, q2.grad) and torch.equal(k1.grad, k2.grad)
    with torch.no_grad():
        assert torch.equal(rope.rotate_qk(q1, k1, t_q, t_k)[0], rq.detach())
    assert rope.rope.launches == before + 3


@pytest.mark.cuda
def test_a_captured_call_replays_with_no_host_read(card):
    from mast3r_slam_torch.ops import rope

    q, k = operands("cross", 1, 12, 768, card, seed=13)
    t_q, t_k = tables(1, (24, 32), 0, 768, card), tables(1, (24, 32), 0, 768, card, shift=2)
    want = rope.rotate_qk(q, k, t_q, t_k)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        rope.rotate_qk(q, k, t_q, t_k)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with no_host_reads(), torch.cuda.graph(graph):
        out = rope.rotate_qk(q, k, t_q, t_k)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, w) for o, w in zip(out, want))


@pytest.mark.cuda
def test_a_window_replays_bit_equal_to_the_plain_rotation(card, monkeypatch):
    from mast3r_slam_torch.config import Config, reset_config, set_config
    from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel, vit
    from mast3r_slam_torch.ops import attention, rope
    from mast3r_slam_torch.tracker import FrameTracker
    from mast3r_slam_torch.workload import BENCH_SETTINGS, drift_frames

    small = MASt3RConfig(enc_embed_dim=128, enc_depth=2, enc_num_heads=2, dec_embed_dim=128,
                         dec_depth=2, dec_num_heads=2, head_type="dpt", dtype=torch.bfloat16)
    model = MASt3RModel.create(cfg=small, resolution=64, seed=1, device="cuda")
    h, w = model.out_hw
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    imgs = torch.from_numpy(drift_frames(base, K, rng)).cuda()
    cfg = set_config(Config.from_dict(BENCH_SETTINGS))
    runs = []
    try:
        for patched in (False, True):
            if patched:
                monkeypatch.setattr(vit, "rotate_qk", rope.rotate_qk_reference)
            rope.rope.launches = attention.flash_attention.launches = 0
            tracker = FrameTracker(model, cfg)
            tracker.init_keyframe(base)
            handle = dispatch(tracker, imgs)
            tracker.sync_chain([handle])
            runs.append(dict(stacked(handle), rope=rope.rope.launches,
                             attention=attention.flash_attention.launches))
    finally:
        reset_config()
    kernel, twin = runs
    assert kernel["attention"] > 0 and kernel["rope"] == kernel["attention"]
    assert twin["rope"] == 0 and twin["attention"] == kernel["attention"]
    # rows: stats, poses T_WCf, pointmaps frame_X / frame_C, features, the keyframe's
    assert {"stats", "T_WCf", "frame_X", "frame_C", "feat"} <= set(kernel)
    for key, value in kernel.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, twin[key]), key
    for key, value in kernel["final"].items():
        assert torch.equal(value, twin["final"][key]), f"final {key}"
