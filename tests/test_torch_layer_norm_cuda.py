"""The LayerNorm kernel (csrc/layer_norm.cu, ops/layer_norm.py) on an NVIDIA
GPU (marked `cuda`: skipped without a card). This file imports no JAX, so it
also runs on a card machine without it, outside the repository's conftest
(which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_layer_norm_cuda.py

The kernel takes a row's statistics as PyTorch's f32 layer norm does on the
card (Welford over 128 threads' groups of 4, a shuffle-down tree, then a tree
over 4 warps; csrc/layer_norm.cu's note), in the same f32 operations, so it
is bit-equal to the plain version: PyTorch's f32 norm of the same x, then
the cast to the output dtype. The cases:

* every (rows, C) the port's paths run (`SHAPES`: vitl's and dune's tokens at
  batch 1, calibrated mode's 640, the backend's batch of 6, serving's 4 and
  16 streams, training's batch 2, and rows and widths at the kernel's edges),
  bf16 and f32 in, bf16 and f32 out: bit-equal, one launch a call,
  contiguous; every width the kernel takes (each sees its own Welford
  counts); a slice of a [B, S, C] along S refused, its contiguous copy
  taken; a row of one repeated value;
* a norm whose statistics are taken in bf16 (`bf16_statistics_norm`, the
  planted fault) is not bit-equal, and fails `bands` too: the looser test
  the kernel would have to meet if its sums ran in another order (bf16 output
  bit-equal to the plain version on at least 99.9% of the elements, and on
  every element the bf16 rounding of a value within TERM_ULPS f32 ulps of the
  affine's terms from the exact norm; f32 output at most twice PyTorch's
  error against float64, plus 1e-6), which tests/test_torch_layer_norm.py
  holds a CPU model of the kernel's arithmetic to;
* a captured call replays with no host read and equals the eager call;
* what the card refuses: a row over 1024 or not a multiple of 8, fp16, a
  weight of another dtype, rows that are not contiguous;
* a call that records a gradient: one launch forward, whose mean and rstd
  are PyTorch's bit for bit, and the output and the gradients of x, weight
  and bias bit-equal to autograd's through the plain version, also through
  a bf16 model under f32 master weights (training's);
* `mast3r_full` and `dunemast3r` on the card: every norm inside a block writes
  bf16 and `enc_norm` / `dec_norm` f32, each call one launch, and an encode
  and a decode bit-equal to the same model with its norms on the plain
  version.
"""

import pytest
import torch
import torch.nn.functional as F

from test_torch_window_graph_cuda import no_host_reads

EPS = 1e-6
BF16_EQUAL_SHARE = 0.999  # bf16 output bit-equal to PyTorch's norm-then-cast on this share
TERM_ULPS = 256  # an f32 result's distance from the exact norm, in f32 ulps of the affine's terms
# (rows, C): the paths' token rows, then the kernel's edges
SHAPES = {
    "vitl enc": (768, 1024),
    "vitl dec": (768, 768),
    "dune enc/dec": (432, 768),
    "dune small enc": (432, 384),
    "calib enc": (640, 1024),
    "backend dec (6 views)": (6 * 768, 768),
    "serving enc (16 streams)": (16 * 768, 1024),
    "serving dec (4 streams)": (4 * 768, 768),
    "training enc (batch 2)": (2 * 768, 1024),
    "one row of 8": (1, 8),
    "3 rows of 72": (3, 72),
    "5 rows of 1000": (5, 1000),
    "7 rows of 1024": (7, 1024),
}
DTYPE_PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
               (torch.float32, torch.float32), (torch.float32, torch.bfloat16)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def tokens(rows: int, c: int, dtype, device, seed: int) -> torch.Tensor:
    """Rows as a residual stream holds them: each its own offset and scale,
    a few channels far larger than the rest."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(rows, c, device=device, generator=g)
    x = x * (0.5 + 4 * torch.rand(rows, 1, device=device, generator=g))
    x = x + 2 * torch.randn(rows, 1, device=device, generator=g)
    loud = torch.rand(c, device=device, generator=g) < 0.01
    return (x + 20 * loud * torch.randn(rows, c, device=device, generator=g)).to(dtype)


def affine(c: int, device, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed)
    return (1 + 0.2 * torch.randn(c, device=device, generator=g),
            0.1 * torch.randn(c, device=device, generator=g))


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in bf16 ulps, element by element (bf16 bits ordered as
    integers; +0 and -0 are one point)."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -32768 - bits, bits)

    return (ordered(a) - ordered(b)).abs()


def bands(got, x, weight, bias, eps: float = EPS) -> dict:
    """`got`, a norm of x rounded to bf16 or f32, against the bands of this
    file's note -> the readings and "ok"."""
    c = x.shape[-1]
    ref = F.layer_norm(x.float(), (c,), weight, bias, eps)
    xd = x.double()
    mean = xd.mean(-1, keepdim=True)
    rstd = torch.rsqrt(xd.var(-1, unbiased=False, keepdim=True) + eps)
    exact = weight.double() * ((xd - mean) * rstd) + bias.double()
    # one f32 ulp of the terms the affine adds, w * rstd * (x - mean) and b, with the
    # row's mean |x| beside x and mean: the scale of the row sums' rounding
    row = xd.abs().mean(-1, keepdim=True)
    unit = 2.0 ** -24 * (weight.double().abs() * rstd * (xd.abs() + mean.abs() + row)
                         + bias.double().abs())
    pytorch_ulps = float(((ref.double() - exact).abs() / unit).max())
    if got.dtype == torch.bfloat16:
        ulps = bf16_ulps(got, ref.to(torch.bfloat16))
        lo, hi = ((exact + d * TERM_ULPS * unit).float().to(torch.bfloat16) for d in (-1, 1))
        inside = bool(((got >= lo) & (got <= hi)).all())
        equal = float((ulps == 0).double().mean())
        return dict(max_ulps=int(ulps.max()), equal_share=equal, inside_term_ulps=inside,
                    pytorch_term_ulps=pytorch_ulps, ok=inside and equal >= BF16_EQUAL_SHARE)
    err = float((got.double() - exact).abs().max())
    err_ref = float((ref.double() - exact).abs().max())
    term_ulps = float(((got.double() - exact).abs() / unit).max())
    return dict(err=err, err_pytorch=err_ref, term_ulps=term_ulps, pytorch_term_ulps=pytorch_ulps,
                ok=err <= 2 * err_ref + 1e-6 and term_ulps <= TERM_ULPS)


def bf16_statistics_norm(x, weight, bias, eps: float, out_dtype) -> torch.Tensor:
    """The planted fault: a norm that takes its mean and variance in bf16
    (each reduction and each operation on them rounded to bf16), the affine
    in f32."""
    xb = x.to(torch.bfloat16)
    mean = xb.mean(-1, keepdim=True)
    var = ((xb - mean) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (weight * (rstd.float() * (x.float() - mean.float())) + bias).to(out_dtype)


def plain(x, weight, bias, out_dtype):
    from mast3r_slam_torch.ops.layer_norm import layer_norm_reference

    return layer_norm_reference(x, weight, bias, EPS, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", DTYPE_PAIRS, ids=lambda p: f"{p[0]}-to-{p[1]}")
@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_kernel_is_bit_equal_to_the_plain_norm_at_the_paths_shapes(card, shape, dtypes):
    from mast3r_slam_torch.ops import layer_norm as ln

    (rows, c), (dt_in, dt_out) = SHAPES[shape], dtypes
    x = tokens(rows, c, dt_in, card, seed=rows + c)
    w, b = affine(c, card, seed=c)
    before = ln.layer_norm.launches
    got = ln.layer_norm(x, w, b, EPS, dt_out)
    assert ln.layer_norm.launches == before + 1
    assert got.dtype == dt_out and got.shape == x.shape and got.is_contiguous()
    assert torch.equal(got, plain(x, w, b, dt_out))


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", DTYPE_PAIRS, ids=lambda p: f"{p[0]}-to-{p[1]}")
def test_every_width_the_kernel_takes_is_bit_equal(card, dtypes):
    """Every C, a multiple of 8 up to 1024: each sees its own Welford counts
    (and the kernel's reciprocals of them)."""
    from mast3r_slam_torch.ops import layer_norm as ln

    dt_in, dt_out = dtypes
    for c in range(8, ln.MAX_WIDTH + 1, 8):
        x = tokens(3, c, dt_in, card, seed=c)
        w, b = affine(c, card, seed=c + 1)
        assert torch.equal(ln.layer_norm(x, w, b, EPS, dt_out), plain(x, w, b, dt_out)), c


@pytest.mark.cuda
@pytest.mark.parametrize("dt_out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ["vitl enc", "dune small enc", "5 rows of 1000"])
def test_statistics_in_bf16_are_caught(card, shape, dt_out):
    rows, c = SHAPES[shape]
    x = tokens(rows, c, torch.bfloat16, card, seed=7 + c)
    w, b = affine(c, card, seed=8)
    planted = bf16_statistics_norm(x, w, b, EPS, dt_out)
    reading = bands(planted, x, w, b)
    print(f"[layer_norm] planted bf16 statistics, {shape} -> {dt_out}: {reading}")
    assert not torch.equal(planted, plain(x, w, b, dt_out)) and not reading["ok"], reading
    assert bands(plain(x, w, b, dt_out), x, w, b)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("dt_out", [torch.bfloat16, torch.float32])
def test_a_slice_along_s_is_refused_and_its_copy_taken(card, dt_out):
    """The sequence-parallel shard x[:, lo:hi] of a [2, 768, C]: its rows
    are not contiguous, so the kernel refuses it; its contiguous copy (what
    parallel/sequence.py hands the norms) is bit-equal to the plain norm."""
    from mast3r_slam_torch.ops import layer_norm as ln

    full = tokens(2 * 768, 1024, torch.bfloat16, card, seed=21).view(2, 768, 1024)
    w, b = affine(1024, card, seed=22)
    for lo, hi in ((0, 384), (384, 768), (100, 356)):
        shard = full[:, lo:hi]
        with pytest.raises(ValueError, match="contiguous rows"):
            ln.layer_norm(shard, w, b, EPS, dt_out)
        got = ln.layer_norm(shard.contiguous(), w, b, EPS, dt_out)
        assert got.is_contiguous() and got.shape == shard.shape
        assert torch.equal(got, plain(shard, w, b, dt_out))


@pytest.mark.cuda
@pytest.mark.parametrize("dt_out", [torch.bfloat16, torch.float32])
def test_a_row_of_one_value(card, dt_out):
    """Variance 0: rstd is rsqrt(eps), the output b up to the mean's rounding."""
    from mast3r_slam_torch.ops import layer_norm as ln

    x = torch.full((4, 768), 3.5, device=card, dtype=torch.bfloat16)
    w, b = affine(768, card, seed=23)
    got = ln.layer_norm(x, w, b, EPS, dt_out)
    assert torch.equal(got, plain(x, w, b, dt_out))
    assert torch.allclose(got.float(), b.expand(4, -1), atol=1e-3, rtol=1e-2)


@pytest.mark.cuda
def test_a_captured_call_replays_with_no_host_read(card):
    from mast3r_slam_torch.ops import layer_norm as ln

    x = tokens(768, 1024, torch.bfloat16, card, seed=31)
    w, b = affine(1024, card, seed=32)
    fresh = tokens(768, 1024, torch.bfloat16, card, seed=33)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ln.layer_norm(x, w, b, EPS, torch.bfloat16)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = ln.layer_norm.launches
    with no_host_reads(), torch.cuda.graph(graph):
        out = ln.layer_norm(x, w, b, EPS, torch.bfloat16)
    assert ln.layer_norm.launches == before + 1  # counted at the capture
    x.copy_(fresh)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ln.layer_norm(fresh, w, b, EPS, torch.bfloat16))
    assert torch.equal(out, plain(fresh, w, b, torch.bfloat16))


@pytest.mark.cuda
def test_the_card_refuses_what_the_kernel_does_not_take(card):
    from mast3r_slam_torch.ops import layer_norm as ln

    w, b = affine(1032, card, seed=41)
    before = ln.layer_norm.launches
    with pytest.raises(ValueError, match="multiple of 8 up to 1024"):
        ln.layer_norm(tokens(4, 1032, torch.bfloat16, card, 1), w, b, EPS, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8 up to 1024"):
        ln.layer_norm(tokens(4, 1028, torch.bfloat16, card, 1), w[:1028], b[:1028], EPS,
                      torch.bfloat16)
    w, b = affine(768, card, seed=42)
    with pytest.raises(TypeError, match="bf16 or f32 CUDA"):
        ln.layer_norm(tokens(4, 768, torch.float16, card, 1), w, b, EPS, torch.bfloat16)
    with pytest.raises(TypeError, match="float32 weight"):
        ln.layer_norm(tokens(4, 768, torch.bfloat16, card, 1), w.bfloat16(), b, EPS,
                      torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous rows"):
        ln.layer_norm(tokens(4, 776, torch.bfloat16, card, 1)[:, 4:772], w, b, EPS, torch.bfloat16)
    assert ln.layer_norm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("records", ["x", "weight and bias", "all"])
@pytest.mark.parametrize("dtypes", DTYPE_PAIRS, ids=lambda p: f"{p[0]}-to-{p[1]}")
@pytest.mark.parametrize("shape", ["training enc (batch 2)", "vitl dec", "5 rows of 1000"])
def test_a_call_that_records_a_gradient_gives_autograds_bits(card, shape, dtypes, records):
    """One launch forward (`_LayerNorm`), its mean and rstd PyTorch's; the
    output and each gradient bit-equal to autograd's through the plain
    version, None where its input records none."""
    from mast3r_slam_torch.ops import layer_norm as ln

    (rows, c), (dt_in, dt_out) = SHAPES[shape], dtypes
    x = tokens(rows, c, dt_in, card, seed=51 + c)
    w, b = affine(c, card, seed=52)
    _, mean, rstd = ln.layer_norm_cuda(x, w, b, EPS, dt_out, stats=True)
    _, want_mean, want_rstd = torch.native_layer_norm(x.float(), [c], w, b, EPS)
    assert torch.equal(mean, want_mean) and torch.equal(rstd, want_rstd)
    need = dict(x=(True, False, False), all=(True, True, True))
    need["weight and bias"] = (False, True, True)
    need = need[records]
    leaves = [[t.detach().clone().requires_grad_(n) for t, n in zip((x, w, b), need)]
              for _ in range(2)]
    before = ln.layer_norm.launches
    got = ln.layer_norm(*leaves[0], EPS, dt_out)
    assert ln.layer_norm.launches == before + 1 and got.requires_grad
    want = F.layer_norm(leaves[1][0].float(), (c,), *leaves[1][1:], EPS).to(dt_out)
    assert torch.equal(got, want)
    g = torch.randn(got.shape, device=card, generator=torch.Generator(card).manual_seed(53))
    got.backward(g.to(dt_out))
    want.backward(g.to(dt_out))
    assert ln.layer_norm.launches == before + 1  # the backward is PyTorch's
    for a, p, n in zip(*leaves, need):
        assert (a.grad is None) == (not n)
        if n:
            assert a.grad.dtype == a.dtype and torch.equal(a.grad, p.grad)


@pytest.mark.cuda
def test_master_weights_train_with_autograds_gradients(card, monkeypatch):
    """A small bf16 model under f32 master weights (training's), with the
    linear head, whose backward gives the same bits twice on the card (the
    DPT head's does not: two runs differ): its loss and every parameter's
    gradient bit-equal with its norms on the kernel and on the plain
    version, one launch a norm."""
    from mast3r_slam_torch import device
    from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel
    from mast3r_slam_torch.ops import layer_norm as ln

    cfg = MASt3RConfig(enc_embed_dim=128, enc_depth=2, enc_num_heads=2, dec_embed_dim=128,
                       dec_depth=2, dec_num_heads=2, head_type="linear", dtype=torch.bfloat16)
    model = MASt3RModel.create(cfg=cfg, resolution=64, seed=2, device="cuda",
                               master_weights=True)
    h, w = model.out_hw
    gen = torch.Generator(card).manual_seed(54)
    imgs = [torch.rand(2, h, w, 3, device=card, generator=gen) * 2 - 1 for _ in range(2)]

    def grads():
        model.net.zero_grad()
        out1, out2 = model.net(*imgs)
        loss = sum(o[k].float().square().mean() for o in (out1, out2) for k in sorted(o))
        loss.backward()
        return [loss.detach()] + [p.grad.clone() for p in model.net.parameters()]

    before = ln.layer_norm.launches
    got = grads()
    # two encodes (2 norms a block and enc_norm) and a decode (4 a block, 2 dec_norms)
    assert ln.layer_norm.launches - before == 2 * (2 * 2 + 1) + 2 * (2 * 4 + 1)
    assert all(torch.equal(a, c) for a, c in zip(got, grads()))  # the same bits twice
    monkeypatch.setattr(device, "layer_norm", ln.layer_norm_reference)
    want = grads()
    assert all(torch.equal(a, c) for a, c in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["mast3r_full", "dunemast3r"])
def test_the_models_norms_write_their_readers_dtype_in_one_launch_each(card, model_type,
                                                                       monkeypatch):
    """An encode and a two-view decode: each norm call one launch; the norms
    inside the blocks write bf16, enc_norm and dec_norm f32; the outputs
    bit-equal to the same model's with its norms on the plain version."""
    from mast3r_slam_torch import device
    from mast3r_slam_torch.models import MASt3RModel
    from mast3r_slam_torch.ops import layer_norm as ln

    model = MASt3RModel.create(model_type, resolution=512 if model_type == "mast3r_full" else 336,
                               seed=0, device="cuda")
    h, w = model.out_hw
    img = torch.rand(1, h, w, 3, device=card, generator=torch.Generator(card).manual_seed(61))
    img = img * 2 - 1
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o, name=name: seen.append((name, o.dtype)))
             for name, m in model.net.named_modules() if isinstance(m, device.LayerNorm)]
    before = ln.layer_norm.launches
    feat, pos = model.encode(img)
    decoded = model.decode(feat, pos, feat, pos)
    torch.cuda.synchronize()
    for hk in hooks:
        hk.remove()
    c = model.cfg
    assert len(seen) == (2 * c.enc_depth + 1) + (8 * c.dec_depth + 2)
    assert ln.layer_norm.launches - before == len(seen)
    for name, dtype in seen:
        want = torch.float32 if name in ("enc_norm", "dec_norm") else torch.bfloat16
        assert dtype == want, (name, dtype)
    monkeypatch.setattr(device, "layer_norm", ln.layer_norm_reference)
    plain_feat, _ = model.encode(img)
    assert torch.equal(feat, plain_feat)
    for got, want in zip(decoded, model.decode(feat, pos, feat, pos)):
        assert all(torch.equal(got[k], want[k]) for k in want)
