"""The RoPE rotation's route and its kernel wrapper (ops/rope.py) on the CPU:
the build registration, the launch counter in the window graph's arithmetic,
the plain route that CPU tensors take (today's expression
``apply_rope(x, cos, sin).to(dtype)``, bit for bit), a call that records a
gradient, the kernel's backward (`backward_tables` and the autograd
function around a stand-in for the kernel) against autograd's gradient
through today's expression, what the wrapper refuses, the launch's arguments, and a model of
the kernel's walk (csrc/rope.cu: four threads a row, each a group of 8 in
both quarters of one half) against `apply_rope`. The kernel itself runs
only on a card: tests/test_torch_rope_cuda.py. This file imports no JAX;
the model's JAX parity tests (tests/test_torch_model.py and the others)
hold the rotation to JAX's.
"""

import numpy as np
import pytest
import torch

from mast3r_slam_torch import graphs
from mast3r_slam_torch.models import vit
from mast3r_slam_torch.ops import build, rope
from mast3r_slam_torch.ops.rope import apply_rope, rotate_qk


def tables(b: int, hp: int, wp: int, head_dim: int = 64):
    """The model's (cos, sin) [b, hp * wp, head_dim] for a grid of patches."""
    yy, xx = torch.meshgrid(torch.arange(hp), torch.arange(wp), indexing="ij")
    pos = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1).to(torch.int32)
    return vit.rope_2d_angles(pos[None].expand(b, -1, -1), head_dim)


def self_qk(b: int, h: int, s: int, dtype, seed: int, head_dim: int = 64):
    """q and k as Attention makes them: strided views of one qkv projection."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, s, 3, h, head_dim, generator=g).to(dtype)
    q, k, _ = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    return q, k


def today(x, cos, sin, dtype):
    """The expression every attention call computed before the kernel."""
    q = x.shape[-1] // 4
    xf = x.float()
    y1, y2, x1, x2 = xf.split(q, dim=-1)
    rot = torch.cat([-y2, y1, -x2, x1], dim=-1)
    return (xf * cos[:, None] + rot * sin[:, None]).to(dtype)


def test_rope_is_built_with_the_other_kernels():
    assert "rope" in build.KERNEL_SOURCES
    src, cmd, out = build._target("rope")
    assert src == build.CSRC / "rope.cu" and src.exists()
    assert cmd[0] == "nvcc" and "arch=compute_90a,code=sm_90a" in cmd
    assert out.parent == build.BUILD_DIR and out.name.startswith("librope-")
    text = src.read_text()
    assert 'extern "C" int rope_qk(' in text
    for name, value in (("kHeadDim", rope.HEAD_DIM), ("kDims", rope.DIMS)):
        assert f"constexpr int {name} = {value};" in text


def test_launch_counter_round_trips_through_the_window_arithmetic():
    before = graphs.launch_counts()
    assert before["rope"] == rope.rope.launches
    graphs.add_launches({"rope": 12, "flash_attention": 12}, 8)  # 12 attention calls a frame
    delta = graphs.launch_delta(before, graphs.launch_counts())
    assert delta == {"rope": 96, "flash_attention": 96}
    graphs.add_launches(graphs.launch_delta(graphs.launch_counts(), before))  # taken back
    assert graphs.launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["self", "cross", "q only", "k only"])
def test_cpu_and_f32_tensors_take_the_plain_route(monkeypatch, dtype, kind):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU rotation reached the kernel's wrapper")

    monkeypatch.setattr(rope, "rope", refuse)
    q, k = self_qk(2, 3, 12, dtype, seed=1)
    t_q = tables(2, 3, 4)
    t_k = t_q if kind == "self" else tables(1, 4, 3)
    if kind == "cross":
        k = torch.randn(2, 12, 3 * 64).to(dtype).view(2, 12, 3, 64).transpose(1, 2)
    rq = None if kind == "k only" else t_q
    rk = None if kind == "q only" else t_k
    got_q, got_k = rotate_qk(q, k, rq, rk)
    want_q = q if rq is None else today(q, *rq, dtype)
    want_k = k if rk is None else today(k, *rk, dtype)
    assert got_q.dtype == got_k.dtype == dtype
    assert torch.equal(got_q, want_q) and torch.equal(got_k, want_k)
    assert (got_q is q) == (rq is None) and (got_k is k) == (rk is None)


def test_no_table_no_work():
    q, k = self_qk(1, 2, 8, torch.bfloat16, seed=2)
    assert rotate_qk(q, k, None, None) == (q, k)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_gradient_recording_call_goes_through_autograd(dtype):
    q, k = self_qk(2, 2, 12, dtype, seed=3)
    cos, sin = tables(2, 3, 4)
    q1, k1 = (t.detach().clone().requires_grad_() for t in (q, k))
    q2, k2 = (t.detach().clone().requires_grad_() for t in (q, k))
    g = torch.Generator().manual_seed(4)
    dq, dk = (torch.randn(q.shape, generator=g).to(dtype) for _ in range(2))
    rq, rk = rotate_qk(q1, k1, (cos, sin), (cos, sin))
    assert rq.requires_grad and rk.requires_grad
    torch.autograd.backward((rq, rk), (dq, dk))
    torch.autograd.backward((today(q2, cos, sin, dtype), today(k2, cos, sin, dtype)), (dq, dk))
    assert torch.equal(q1.grad, q2.grad) and torch.equal(k1.grad, k2.grad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", ["model", "random"])
def test_the_backward_tables_rotate_a_gradient_as_autograd_does(dtype, which):
    """The gradient of today's expression is the rotation of the cotangent by
    `backward_tables`, bit for bit, for the model's tables and any others."""
    x, _ = self_qk(2, 3, 12, dtype, seed=8)
    cos, sin = tables(2, 3, 4)
    if which == "random":
        g = torch.Generator().manual_seed(9)
        cos, sin = (torch.randn(cos.shape, generator=g) for _ in range(2))
    x = x.detach().clone().requires_grad_()
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(10)).to(dtype)
    today(x, cos, sin, dtype).backward(dy)
    got, same = rope.rotate_qk_reference(dy, dy, rope.backward_tables((cos, sin)), None)
    assert same is dy and got.dtype == dtype
    assert torch.equal(got, x.grad)
    assert rope.backward_tables(None) is None


@pytest.mark.parametrize("kind", ["self", "cross", "q only", "k only"])
def test_the_autograd_function_gives_todays_gradient(monkeypatch, kind):
    """`_Rope` (the route of a CUDA call that records a gradient) around a
    stand-in for the kernel that checks the layout as the wrapper does and
    computes the kernel's bits on the CPU: the forward and the backward one
    call each, the gradients today's, an expanded cotangent too."""
    calls = []

    def kernel(q, k, rope_q, rope_k):  # the wrapper's layout checks, then the kernel's bits
        for name, x, table in (("q", q, rope_q), ("k", k, rope_k)):
            if table is not None:
                rope._dims(name, x, *table)
        calls.append((rope_q is not None, rope_k is not None))
        return rope.rotate_qk_reference(q, k, rope_q, rope_k)

    monkeypatch.setattr(rope, "rope", kernel)
    q, k = self_qk(2, 3, 12, torch.bfloat16, seed=11)
    t_q = tables(2, 3, 4)
    t_k = t_q if kind == "self" else tables(1, 4, 3)
    rq = None if kind == "k only" else t_q
    rk = None if kind == "q only" else t_k
    g = torch.Generator().manual_seed(12)
    dq, dk = (torch.randn(q.shape, generator=g).to(torch.bfloat16) for _ in range(2))
    for cot in ((dq, dk), (torch.ones((), dtype=torch.bfloat16).expand(q.shape),) * 2):
        calls.clear()
        q1, k1 = (t.detach().clone().requires_grad_() for t in (q, k))
        q2, k2 = (t.detach().clone().requires_grad_() for t in (q, k))
        got = rope._Rope.apply(q1, k1, rq, rk)
        want = rope.rotate_qk_reference(q2, k2, rq, rk)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
        torch.autograd.backward(got, cot)
        torch.autograd.backward(want, cot)
        assert calls == [(rq is not None, rk is not None)] * 2
        assert torch.equal(q1.grad, q2.grad) and torch.equal(k1.grad, k2.grad)


def test_the_autograd_function_refuses_tables_that_record_a_gradient(monkeypatch):
    monkeypatch.setattr(rope, "rope", rope.rotate_qk_reference)
    q, k = self_qk(1, 2, 12, torch.bfloat16, seed=13)
    cos, sin = tables(1, 3, 4)
    with pytest.raises(ValueError, match="no gradient of the tables"):
        rope._Rope.apply(q.requires_grad_(), k, (cos, sin.requires_grad_()), None)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    q, k = self_qk(1, 2, 12, torch.bfloat16, seed=5)
    t = tables(1, 3, 4)
    with pytest.raises(ValueError, match="last stride"):
        rope.rope(torch.zeros(1, 2, 12, 128, dtype=torch.bfloat16)[..., ::2], k, t, t)
    with pytest.raises(ValueError, match="last stride"):
        rope.rope(q, k, (t[0].transpose(1, 2).contiguous().transpose(1, 2), t[1]), t)
    with pytest.raises(ValueError, match="multiples of 8"):
        rope.rope(torch.zeros(1, 2, 12, 65, dtype=torch.bfloat16)[..., :64], k, t, t)
    with pytest.raises(ValueError, match="takes \\[B, H, S, 64\\]"):
        rope.rope(q[..., :32], k[..., :32], tables(1, 3, 4, 32), tables(1, 3, 4, 32))
    with pytest.raises(ValueError, match="tables are"):
        rope.rope(q, k, tables(1, 4, 4), t)
    with pytest.raises(ValueError, match="tables are"):
        rope.rope(q, k, tables(3, 3, 4), t)
    with pytest.raises(TypeError, match="bf16 CUDA"):
        rope.rope(q, k, t, t)
    with pytest.raises(TypeError, match="bf16 CUDA"):
        rope.rope(q.float(), k.float(), t, t)


def test_the_launch_hands_the_kernel_its_arguments_in_order(monkeypatch):
    """`_launch` against the C interface (csrc/rope.cu `rope_qk`): the stream,
    the number of tensors, 4 pointers a tensor (x, cos, sin, out), then DIMS
    numbers a tensor: B, H, S, x's strides, cos's and sin's (0 where a
    dimension has one element or the table is broadcast over the batch)."""
    seen = {}

    class Lib:
        def rope_qk(self, *args):
            seen["args"] = args
            return 0

    class Stream:
        cuda_stream = 77

    monkeypatch.setattr(rope, "_lib", Lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    q, _ = self_qk(2, 4, 6, torch.bfloat16, seed=6)  # strides (4608, 64, 768, 1)
    kx = torch.zeros(1, 5, 4 * 64, dtype=torch.bfloat16).view(1, 5, 4, 64).transpose(1, 2)
    tq, tk = tables(1, 2, 3), tables(1, 1, 5)
    pairs = [(q, *tq, torch.empty(q.shape, dtype=q.dtype)),
             (kx, *tk, torch.empty(kx.shape, dtype=kx.dtype))]
    dims = rope._dims("q", q, *tq) + rope._dims("k", kx, *tk)
    assert len(dims) == 2 * rope.DIMS
    assert dims == [2, 4, 6, 4608, 64, 768, 0, 64, 0, 64, 1, 4, 5, 0, 64, 256, 0, 64, 0, 64]
    rope._launch(pairs, dims)
    args = seen["args"]
    assert args[:2] == (77, 2)
    assert list(args[2]) == [t.data_ptr() for pair in pairs for t in pair]
    assert list(args[3]) == dims


def kernel_walk(x: np.ndarray, cos: np.ndarray, sin: np.ndarray):
    """csrc/rope.cu's arithmetic on one row of 64 (f32 numpy): four threads
    (`part`), each the 8 elements of vector v0 = (part >> 1) * 4 + (part & 1)
    and their partners 16 on -> (the rotated row in f32, how often each
    element was written)."""
    out, writes = np.zeros(64, np.float32), np.zeros(64, int)
    for part in range(4):
        v0 = (part >> 1) * 4 + (part & 1)
        a = 8 * v0 + np.arange(8)
        c = a + 16
        out[a] = x[a] * cos[a] + (-x[c]) * sin[a]  # numpy f32: each op rounded once
        out[c] = x[c] * cos[c] + x[a] * sin[c]
        writes[a] += 1
        writes[c] += 1
    return out, writes


def test_the_kernel_walk_is_apply_rope():
    q, _ = self_qk(1, 3, 12, torch.bfloat16, seed=7)
    cos, sin = tables(1, 3, 4)
    want = apply_rope(q, cos, sin)
    xs, cs, ss = q.float().numpy(), cos.numpy(), sin.numpy()
    for h in range(3):
        for s in range(12):
            row, writes = kernel_walk(xs[0, h, s], cs[0, s], ss[0, s])
            assert (writes == 1).all()
            assert np.array_equal(row.view(np.int32), want[0, h, s].numpy().view(np.int32))
