"""The LayerNorm's route and its kernel wrapper (ops/layer_norm.py) on the
CPU: the build registration, the launch counter in the window graph's
arithmetic, the plain route that CPU tensors take (today's f32 norm, then the
cast, bit for bit, and autograd's gradients through it), the route of a CUDA
call pinned with meta tensors and stand-ins for both versions, the backward of
a gradient-recording call on the card (`_LayerNorm`, PyTorch's layer norm
backward on the kernel's mean and rstd) with a CPU stand-in for the kernel,
each norm's output
dtype by module name under the dtype policy, a bf16 model's outputs and a
master-weights model's gradients bit-equal to those of today's norms (f32 out,
cast by the Linear that reads it), the tiny net's JAX parity, what the
wrapper refuses (rows that are not contiguous among them), the launch's
arguments, and a model of the kernel's walk
(csrc/layer_norm.cu: a warp a row, each lane four of PyTorch's Welford
threads, their shuffle-down and warp trees) held to the bands of
tests/test_torch_layer_norm_cuda.py, which the planted fault (statistics in
bf16) fails. The kernel itself runs only on a
card: tests/test_torch_layer_norm_cuda.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mast3r_slam_torch import device, graphs
from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel
from mast3r_slam_torch.models.mast3r import MASt3RNet
from mast3r_slam_torch.ops import build
from mast3r_slam_torch.ops import layer_norm as ln
from test_torch_layer_norm_cuda import EPS, affine, bands, bf16_statistics_norm, tokens

BLOCK_NORMS = ("norm1", "norm2", "norm_y", "norm3")  # inside a block: read by compute layers
SMALL_BF16 = MASt3RConfig(enc_embed_dim=64, enc_depth=2, enc_num_heads=2, dec_embed_dim=64,
                          dec_depth=2, dec_num_heads=2, head_type="dpt", dtype=torch.bfloat16)


def today(x, weight, bias, eps, out_dtype):
    """What every norm computed before the kernel: f32 out, then the reader's cast."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps).to(out_dtype)


def todays_forward(self, x):
    """`device.LayerNorm.forward` before the kernel: f32 out, whatever reads it."""
    return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


def test_layer_norm_is_built_with_the_other_kernels():
    assert "layer_norm" in build.KERNEL_SOURCES
    src, cmd, out = build._target("layer_norm")
    assert src == build.CSRC / "layer_norm.cu" and src.exists()
    assert cmd[0] == "nvcc" and "arch=compute_90a,code=sm_90a" in cmd
    assert out.parent == build.BUILD_DIR and out.name.startswith("liblayer_norm-")
    text = src.read_text()
    assert 'extern "C" int layer_norm_rows(' in text
    assert f"static_assert(kMaxC == {ln.MAX_WIDTH}," in text


def test_launch_counter_round_trips_through_the_window_arithmetic():
    before = graphs.launch_counts()
    assert before["layer_norm"] == ln.layer_norm.launches
    graphs.add_launches({"layer_norm": 147, "flash_attention": 72}, 8)  # a vitl frame's
    delta = graphs.launch_delta(before, graphs.launch_counts())
    assert delta == {"layer_norm": 1176, "flash_attention": 576}
    graphs.add_launches(graphs.launch_delta(graphs.launch_counts(), before))  # taken back
    assert graphs.launch_counts() == before


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grad", [False, True])
def test_cpu_tensors_take_the_plain_route_bit_for_bit(monkeypatch, in_dtype, out_dtype, grad):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU norm reached the kernel's wrapper")

    monkeypatch.setattr(ln, "layer_norm_cuda", refuse)
    x = tokens(24, 64, in_dtype, "cpu", seed=1).view(2, 12, 64)
    w, b = affine(64, "cpu", seed=2)
    if grad:
        x, w, b = (t.detach().clone().requires_grad_() for t in (x, w, b))
    before = ln.layer_norm.launches
    got = ln.layer_norm(x, w, b, EPS, out_dtype)
    assert ln.layer_norm.launches == before
    assert got.dtype == out_dtype and got.requires_grad == grad
    assert torch.equal(got, today(x, w, b, EPS, out_dtype))
    if grad:  # and autograd's gradient through it is today's
        g = torch.randn(got.shape, generator=torch.Generator().manual_seed(3)).to(out_dtype)
        got_grads = torch.autograd.grad(got, (x, w, b), g)
        want_grads = torch.autograd.grad(today(x, w, b, EPS, out_dtype), (x, w, b), g)
        assert all(torch.equal(a, c) for a, c in zip(got_grads, want_grads))


@pytest.mark.parametrize("records", ["x", "weight", "bias", "none", "no_grad"])
def test_the_route_of_a_card_call(monkeypatch, records):
    """Meta tensors stand for CUDA ones: every call takes the kernel, one
    that records a gradient through `_LayerNorm` (the kernel with its row
    statistics); the plain version never."""
    calls = []

    def kernel(x, weight, bias, eps, out_dtype, stats=False):
        calls.append("kernel with statistics" if stats else "kernel")
        out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
        moments = [torch.empty((*x.shape[:-1], 1), device=x.device) for _ in range(2 * stats)]
        return (out, *moments) if stats else out

    monkeypatch.setattr(ln, "layer_norm_cuda", kernel)
    monkeypatch.setattr(ln, "layer_norm_reference", lambda *a: calls.append("plain"))
    x = torch.empty(2, 12, 64, device="meta", dtype=torch.bfloat16)
    w, b = torch.empty(64, device="meta"), torch.empty(64, device="meta")
    named = {"x": x, "weight": w, "bias": b}
    if records in named:
        named[records].requires_grad_()
    if records == "no_grad":
        w.requires_grad_()
        with torch.no_grad():
            got = ln.layer_norm(x, w, b, EPS, torch.bfloat16)
    else:
        got = ln.layer_norm(x, w, b, EPS, torch.bfloat16)
    assert calls == ["kernel with statistics" if records in named else "kernel"]
    assert got.dtype == torch.bfloat16 and got.requires_grad == (records in named)


def cpu_kernel(x, weight, bias, eps, out_dtype, stats=False):
    """A stand-in for the kernel on CPU tensors: PyTorch's f32 norm rounded
    to `out_dtype`, with its mean and rstd where `stats` asks."""
    y, mean, rstd = torch.native_layer_norm(x.float(), [x.shape[-1]], weight, bias, eps)
    return (y.to(out_dtype), mean, rstd) if stats else y.to(out_dtype)


@pytest.mark.parametrize("records", ["x", "weight and bias", "all"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
def test_the_card_backward_is_autograds_through_the_plain_version(monkeypatch, in_dtype,
                                                                   out_dtype, records):
    """`_LayerNorm` with the kernel's stand-in: its output and its
    gradients of x, weight and bias bit-equal to autograd's through today's
    norm, a gradient left None where its input records none."""
    monkeypatch.setattr(ln, "layer_norm_cuda", cpu_kernel)
    x = tokens(24, 64, in_dtype, "cpu", seed=18).view(2, 12, 64)
    w, b = affine(64, "cpu", seed=19)
    wants = dict(x=(True, False, False), all=(True, True, True))
    wants["weight and bias"] = (False, True, True)
    need = wants[records]
    leaves = [[t.detach().clone().requires_grad_(n) for t, n in zip((x, w, b), need)]
              for _ in range(2)]
    got = ln.layer_norm(*leaves[0], EPS, out_dtype)
    want = today(*leaves[1], EPS, out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(20)).to(out_dtype)
    got.backward(g)
    want.backward(g)
    for a, c, n in zip(*leaves, need):
        assert (a.grad is None) == (not n)
        if n:
            assert a.grad.dtype == a.dtype and torch.equal(a.grad, c.grad)


def net_on_meta(cfg: MASt3RConfig, master_weights: bool = False) -> MASt3RNet:
    with torch.device("meta"):
        net = MASt3RNet(cfg)
    return device.apply_dtype_policy(net, cfg.dtype, master_weights)


@pytest.mark.parametrize("master_weights", [False, True])
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
@pytest.mark.parametrize("model", ["mast3r_full", "dunemast3r", "dunemast3r small", "tiny"])
def test_each_norm_writes_its_readers_dtype(model, precision, master_weights):
    """bf16 from the norms inside the blocks of a bf16 model, f32 from
    enc_norm and dec_norm, f32 everywhere in an f32 model and under master
    weights."""
    cfg = {"mast3r_full": lambda: MASt3RConfig.mast3r_full(precision),
           "dunemast3r": lambda: MASt3RConfig.dunemast3r("base", precision),
           "dunemast3r small": lambda: MASt3RConfig.dunemast3r("small", precision),
           "tiny": MASt3RConfig.tiny}[model]()
    net = net_on_meta(cfg, master_weights)
    norms = {name: m for name, m in net.named_modules() if isinstance(m, device.LayerNorm)}
    assert len(norms) == 2 * cfg.enc_depth + 1 + 8 * cfg.dec_depth + 1
    for name, m in norms.items():
        inside = name.rpartition(".")[2] in BLOCK_NORMS
        assert inside == (name not in ("enc_norm", "dec_norm")), name
        assert m.feeds_compute == inside and m.weight.dtype == torch.float32
        want = cfg.dtype if inside and not master_weights else torch.float32
        assert m.out_dtype == want, (name, m.out_dtype)


def outputs(model, img):
    """Encode, two-view decode and mono decode of one image, flattened."""
    feat, pos = model.encode(img)
    outs = model.decode(feat, pos, feat, pos)
    return [feat, *(o[k] for o in outs for k in sorted(o)), *model.mono(feat[0], pos[0])]


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_a_bf16_model_computes_todays_bits(monkeypatch, quant):
    model = MASt3RModel.create(cfg=SMALL_BF16, resolution=64, seed=1, device="cpu",
                               weight_quant=quant)
    h, w = model.out_hw
    img = torch.rand(1, h, w, 3, generator=torch.Generator().manual_seed(4)) * 2 - 1
    got = outputs(model, img)
    assert model.net.enc_blocks[0].norm1.out_dtype == torch.bfloat16
    monkeypatch.setattr(device.LayerNorm, "forward", todays_forward)
    want = outputs(model, img)
    assert all(torch.equal(a, c) for a, c in zip(got, want))


def test_master_weights_give_todays_gradients(monkeypatch):
    """Training's route: a master-weights bf16 model's loss and every
    parameter's gradient bit-equal to those through today's norms."""
    model = MASt3RModel.create(cfg=SMALL_BF16, resolution=64, seed=2, device="cpu",
                               master_weights=True)
    h, w = model.out_hw
    g = torch.Generator().manual_seed(5)
    imgs = [torch.rand(2, h, w, 3, generator=g) * 2 - 1 for _ in range(2)]

    def grads():
        model.net.zero_grad()
        out1, out2 = model.net(*imgs)
        loss = sum(o[k].float().square().mean() for o in (out1, out2) for k in sorted(o))
        loss.backward()
        return [loss.detach()] + [p.grad.clone() for p in model.net.parameters()]

    got = grads()
    monkeypatch.setattr(device.LayerNorm, "forward", todays_forward)
    want = grads()
    assert all(torch.equal(a, c) for a, c in zip(got, want))


def test_the_tiny_net_still_matches_jax():
    from test_torch_helpers import tiny_pair
    from test_torch_model import check_encode_decode

    jm, tm = tiny_pair("linear")
    assert all(m.out_dtype == torch.float32 for m in tm.net.modules()
               if isinstance(m, device.LayerNorm))
    check_encode_decode(jm, tm)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    w, b = affine(64, "cpu", seed=6)
    x = tokens(4, 64, torch.bfloat16, "cpu", seed=7)
    with pytest.raises(TypeError, match="bf16 or f32 CUDA"):
        ln.layer_norm_cuda(x, w, b, EPS, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8 up to 1024"):
        ln.layer_norm_cuda(x[:, :60], w[:60], b[:60], EPS, torch.bfloat16)
    wide = affine(1032, "cpu", seed=8)
    with pytest.raises(ValueError, match="multiple of 8 up to 1024"):
        ln.layer_norm_cuda(tokens(4, 1032, torch.bfloat16, "cpu", 9), *wide, EPS, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous rows"):
        ln.layer_norm_cuda(tokens(4, 128, torch.bfloat16, "cpu", 10)[:, ::2], w, b, EPS,
                           torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous rows"):
        ln.layer_norm_cuda(tokens(4, 72, torch.bfloat16, "cpu", 11)[:, 4:68], w, b, EPS,
                           torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous rows"):
        ln.layer_norm_cuda(tokens(2 * 3 * 8, 64, torch.bfloat16, "cpu", 12).view(2, 3, 8, 64)
                           [:, :, :4], w, b, EPS, torch.bfloat16)


@pytest.mark.parametrize("layout", ["contiguous", "one row", "2-D", "slice along S",
                                    "batch of one sliced", "empty"])
def test_the_rows_the_kernel_is_handed(layout):
    """The kernel takes contiguous rows: each layout that is passes the
    layout check (and, on the CPU, stops at the device check); a slice along
    S of a batch of more than one (the sequence-parallel shard before its
    copy) is refused."""
    full = tokens(2 * 10, 64, torch.bfloat16, "cpu", seed=13).view(2, 10, 64)
    x, taken = {
        "contiguous": (full, True),
        "one row": (full[0, 0], True),
        "2-D": (full.view(20, 64), True),
        "slice along S": (full[:, 3:7], False),
        "batch of one sliced": (full[:1, 3:7], True),
        "empty": (full[:, :0], True),
    }[layout]
    w, b = affine(64, "cpu", seed=14)
    assert x.is_contiguous() == taken
    with pytest.raises(TypeError if taken else ValueError,
                       match="bf16 or f32 CUDA" if taken else "contiguous rows"):
        ln.layer_norm_cuda(x, w, b, EPS, torch.bfloat16)


def test_the_launch_hands_the_kernel_its_arguments_in_order(monkeypatch):
    """`_launch` against the C interface (csrc/layer_norm.cu
    `layer_norm_rows`): the stream, x, weight, bias, out, mean and rstd (None
    where the call asks for no statistics), then rows, C, eps, and whether x
    and out are bf16."""
    seen = {}

    class Lib:
        def layer_norm_rows(self, *args):
            seen["args"] = args
            return 0

    class Stream:
        cuda_stream = 77

    monkeypatch.setattr(ln, "_lib", Lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    x = tokens(2 * 6, 64, torch.bfloat16, "cpu", seed=14).view(2, 6, 64)
    w, b = affine(64, "cpu", seed=15)
    out = torch.empty(x.shape)
    ln._launch(x, w, b, out, [], 12, EPS)
    assert seen["args"] == (77, x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                            None, None, 12, 64, EPS, 1, 0)
    mean, rstd = torch.empty(2, 6, 1), torch.empty(2, 6, 1)
    ln._launch(x.float(), w, b, out.bfloat16(), [mean, rstd], 12, EPS)
    assert seen["args"][5:] == (mean.data_ptr(), rstd.data_ptr(), 12, 64, EPS, 0, 1)
    seen.clear()
    monkeypatch.setattr(ln, "_lib", lambda: type("Failing", (), {
        "layer_norm_rows": lambda self, *a: 98})())
    with pytest.raises(RuntimeError, match="cudaError 98"):
        ln._launch(x, w, b, out, [], 12, EPS)


def f32(v) -> np.float32:
    return np.float32(v)


def fma(a, b, c) -> np.float32:
    """a * b + c rounded once to f32 (through float64, exact for the product)."""
    return f32(np.float64(a) * np.float64(b) + np.float64(c))


def online(val, state, n):
    """PyTorch's Welford update of a thread's n-th element, as the kernel
    writes it (two multiply-adds)."""
    mean, sigma2, count = state
    delta = f32(val - mean)
    new_mean = fma(delta, f32(f32(1) / f32(n)), mean)
    return new_mean, fma(delta, f32(val - new_mean), sigma2), f32(count + 1)


def combine(own, other):
    """PyTorch's cuWelfordCombine(own, other), as the kernel writes it."""
    (mb, sb, cb), (ma, sa, ca) = own, other
    delta, count = f32(mb - ma), f32(ca + cb)
    if count <= 0:
        return f32(0), f32(0), count
    coef = f32(f32(1) / count)
    na, nb = f32(ca * coef), f32(cb * coef)
    return (fma(na, ma, f32(nb * mb)), fma(f32(f32(delta * delta) * ca), nb, f32(sa + sb)),
            count)


def kernel_walk(x: np.ndarray, w: np.ndarray, b: np.ndarray, eps: float):
    """csrc/layer_norm.cu's arithmetic on one row (f32 numpy): lane l stands
    for PyTorch's threads t = l + 32 y (y < 4), each a Welford state over its
    groups of 4 g = t, t + 128 in order; the lanes' states combined by a
    shuffle-down tree (a lane past the warp's end reads its own), then the
    threads' warps 0 with 2, 1 with 3, 0 with 1; y = w * (rstd * (x - mean)) +
    b, a multiply-add -> (y in f32, how often each element was written)."""
    c = x.shape[0]
    slots = [[[g for g in (l + 32 * y, l + 32 * y + 128) if g < c // 4] for y in range(4)]
             for l in range(32)]
    states = [[(f32(0), f32(0), f32(0)) for _ in range(4)] for _ in range(32)]
    for lane in range(32):
        for y in range(4):
            for k, g in enumerate(slots[lane][y]):
                for e in range(4):
                    states[lane][y] = online(x[4 * g + e], states[lane][y], 4 * k + e + 1)
    for offset in (16, 8, 4, 2, 1):
        states = [[combine(states[lane][y], states[lane + offset if lane + offset < 32 else lane][y])
                   for y in range(4)] for lane in range(32)]
    s = states[0]
    s0, s1 = combine(s[0], s[2]), combine(s[1], s[3])
    mean, sigma2, _ = combine(s0, s1)
    rstd = f32(1 / np.sqrt(np.float64(f32(f32(sigma2 / f32(c)) + f32(eps)))))
    y, writes = np.zeros(c, np.float32), np.zeros(c, int)
    for lane in range(32):
        for groups in slots[lane]:
            for g in groups:
                for i in range(4 * g, 4 * g + 4):
                    y[i] = fma(w[i], f32(rstd * f32(x[i] - mean)), b[i])
                    writes[i] += 1
    return y, writes


@pytest.mark.parametrize("c", [8, 72, 384, 768, 1000, 1024])
def test_the_kernel_walk_writes_each_element_once_inside_the_bands(c):
    rows = 4 if c >= 384 else 32
    x = tokens(rows, c, torch.bfloat16, "cpu", seed=c)
    w, b = affine(c, "cpu", seed=c + 1)
    walked = []
    for row in x.float().numpy():
        y, writes = kernel_walk(row, w.numpy(), b.numpy(), EPS)
        assert (writes == 1).all()
        walked.append(y)
    y = torch.from_numpy(np.stack(walked))
    for out in (y, y.to(torch.bfloat16)):
        assert bands(out, x, w, b)["ok"], bands(out, x, w, b)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_statistics_in_bf16_fail_the_bands_on_the_cpu(out_dtype):
    x = tokens(768, 1024, torch.bfloat16, "cpu", seed=16)
    w, b = affine(1024, "cpu", seed=17)
    assert not bands(bf16_statistics_norm(x, w, b, EPS, out_dtype), x, w, b)["ok"]
    assert bands(ln.layer_norm(x, w, b, EPS, out_dtype), x, w, b)["ok"]
